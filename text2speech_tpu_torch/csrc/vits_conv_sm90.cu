// The convolutions of VITS's HiFi-GAN generator (models/vits.py Generator)
// on Hopper (sm_90a), channels-last, with the elementwise work between them
// done in their prologues and epilogues: one implicit-GEMM kernel family on
// wgmma and TMA for 77 of a pass's 78 convolutions, and an FMA kernel for
// conv_post.
//
// It replaces no TPU kernel: VITS has no counterpart in the JAX package.
// It was added because the eager cuDNN generator (ops/vits_conv.py keeps it
// as first_design) spent ~63% of its device time on NCW <-> NHWC transposes
// around each convolution and on a pass of its own for every leaky ReLU,
// residual add, resblock sum and division (PERF.md, the VITS cell's
// breakdown).
//
// Layout.  Activations are [B, T, C] bf16.  For an output row t and a
// convolution of k taps at dilation d (pad lo = (k - 1) d / 2):
//
//   y[t] = epi( sum_j pro(x[t - lo + j d]) W_j + b )
//   pro  = leaky ReLU 0.1, or nothing
//   epi  = leaky ReLU 0.1 | (+ res[t] (+ sum[t])) * scale | nothing
//
// with rows outside [0, T) read as zeros.  A transposed convolution of
// stride u and k = 2u taps (padding u / 2) is u phases of a two-tap
// convolution over the input rows: out[t u + p] = x[t + s - 1] W_a +
// x[t + s] W_b + b, s = 1 for phases p >= u - u / 2 (else 0), with its
// input's leaky ReLU as the prologue.  Every sum is f32; each output is
// rounded to bf16 once, when it is stored.  Roles (ops/vits_conv.py):
// conv_pre (no prologue), a resblock pair's first conv (leaky ReLU in and
// out), its second (residual, on the last pair of resblocks 2 and 3 the
// running sum and on resblock 3 the 1/3), the transposed convolutions.
//
// What bounds it on an H100.  Over one pass at B = 32 and ~1,200 frames
// the convolutions' bound is ~32 ms: 23.6 TFLOP and 77.8 GB
// (perfbench/roofline_vits.py).  The 256- and 128-channel stages lean on
// the tensor cores (~2,000 and ~1,000 FLOP a byte moved), the 64- and
// 32-channel stages on memory (~500 and ~250, against the card's 295 when
// every conv reads and writes 2 bytes a channel).  So the design keeps
// the tensor cores fed where C is wide and the memory busy where it is
// narrow, and moves each activation through HBM once per read.
//
// Design: one algorithm, its tile chosen from C_out, k and d.
//
// * M is output rows, N is C_out (one N tile of min(C_out, 256) columns;
//   conv_pre's 512 are two), K is taps x C_in.  A block is two consumer
//   warpgroups and one producer warp; each warpgroup owns MT 64-row
//   wgmma tiles (the host plan's MT: 1, 2, 2, 4 at N = 256, 128, 64, 32;
//   1 for the 256 -> 128 transposed convolution), a block BM = 128 MT
//   rows: long time tiles where C is narrow, wide N where it is wide.  Up
//   to 64 accumulator registers a thread, the kernel asks for two blocks
//   an SM, so that one block's prologue and epilogue run beside the
//   other's products; 128 take one.  The register file is split four
//   ways, so 9 warps a block cap a thread at 168 registers (96 with two
//   blocks); the tiles at the cap but N = 256 spill 8-40 bytes, never an
//   accumulator tile (chip_smoke.py phase 33 prints them and holds them
//   to that).  One block an SM clears the spills of the 96-register
//   tiles but costs 10-40% at 64 and 32 channels (PERF.md).  The grid is
//   persistent over (N tile, batch row, time tile).
// * The activation window.  The rows [t0 - lo, t0 + BM + (k - 1) d - lo)
//   of all C_in channels come into one shared-memory slot by TMA, once per
//   tile for all k taps (and all u phases), with TMA's zero fill outside
//   [0, T).  The slot is wgmma's no-swizzle K-major layout: 8-channel
//   columns of 16-byte rows, [C_in / 8][rows][8], one 16-byte-wide box a
//   column.  A core matrix is any 8 consecutive rows of a column, so each
//   tap's A operand is a descriptor at a row offset (16 bytes a row): no
//   ldmatrix, no A in registers (PERF.md: an ldmatrix-fed A made ptxas
//   serialise every wgmma).  The prologue's leaky ReLU runs once over the
//   slot in shared memory.
// * Weights are packed once at load (ops/vits_conv.py pack) into the
//   stage images the kernel reads, in consumption order: [N tile][phase]
//   [tap][K chunk of KC][KC / 8][N][8].  A stage comes in by one bulk copy.
//   Where all of a convolution's stages fit beside two window slots they
//   are loaded once per block and stay; otherwise a ring of NW stages
//   streams them per tile and the window ring has one or two slots.  The
//   host plan (ops/vits_conv.py plan) picks.
// * Epilogue.  The f32 accumulators start at the bias (no bias loads in
//   the epilogue: 6% off a pass, PERF.md), then take the activation, the
//   residual, the running sum (read from device memory in the
//   accumulators' layout: 8 of a pass's convolutions) and the scale, are
//   rounded once into the warpgroup's staging tile in shared memory, and
//   one TMA store a tile writes whole rows (N = 256 in two halves of 128
//   columns); the transposed convolution's phase p writes rows t u + p,
//   as columns p C_out of out seen as [B, T, u C_out].  The residual rows
//   come into the staging tile by TMA during the tile's products, issued
//   as soon as the last store has read it.  Stores from registers (4
//   bytes a thread, half sectors) took half of each kernel's time
//   (PERF.md).
// * One convolution, one kernel: no output stays on chip for the next
//   convolution, so every kernel moves what the yardstick counts.
//
// conv_post (C -> 1, k 7, no bias) has N = 1, which wgmma does not take:
// an FMA kernel stages 512 rows and their halo through shared memory with
// leaky ReLU 0.01 applied, and each thread sums k C products for an output
// sample in f32 and writes tanh of it as f32 audio.
//
// Measured times are in PERF.md.

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int NWG = 2;                   // consumer warpgroups
constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
constexpr int MAX_NA = 2;                // window slots
constexpr int MAX_NW = 16;               // weight stages
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory, bytes
constexpr float SLOPE = 0.1f;
constexpr float POST_SLOPE = 0.01f;
constexpr int POST_ROWS = 512;           // conv_post: rows a block

__host__ __device__ constexpr int kc_of(int N) {
  return (N == 256 || N == 32) ? 32 : 64;
}

// Columns of the epilogue's staging tile: N, or N = 256 in two halves.
__host__ __device__ constexpr int en_of(int N) { return N < 128 ? N : 128; }

struct Args {
  CUtensorMap map_x;    // x [B, T, C_in]; box {8, Rb, 1}
  CUtensorMap map_out;  // out as [B, T, P C_out]; box {EN, 64 MT, 1}
  CUtensorMap map_res;  // res [B, T, C_out]; box {EN, 64 MT, 1}
  const bf16* w;      // packed stages [n_tiles][S][KC / 8][N][8]
  const bf16* bias;   // [C_out] or null
  const bf16* sum;    // [B, T, C_out] or null (P == 1)
  int has_res;        // res given (P == 1)
  int B, T, C_in, C_out, taps, d, lo, P, p_shift, pro, epi_lrelu;
  float scale;
  int Rb, nb, Rs, NA, NW, resident;
  int S;              // weight stages a tile: P taps C_in / KC
  int tiles_b, tiles; // time tiles a batch row; all tiles
};

// Dynamic shared memory: the window slots, the weight stages and each
// consumer warpgroup's staging tile [64 MT][EN], after 1 KB of alignment.
__host__ __device__ inline size_t conv_smem(int C_in, int N, int MT, int Rs,
                                            int NA, int n_stages) {
  return 1024 + (size_t)NA * C_in * Rs * 2 +
         (size_t)n_stages * kc_of(N) * N * 2 +
         (size_t)NWG * 64 * MT * en_of(N) * 2;
}

// --- PTX ---------------------------------------------------------------------

#define ACC4(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define ACC16(b) ACC4(b), ACC4(b + 4), ACC4(b + 8), ACC4(b + 12)
#define ACC32(b) ACC16(b), ACC16(b + 16)
#define ACC64(b) ACC32(b), ACC32(b + 32)

// d += A x B, A and B K-major in shared memory with no swizzle; d as in
// sm90.cuh's wgmma_n256.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC16(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_kk(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 256) {
    wgmma_n256<0, 0>(d, da, db, 1);
  } else if constexpr (N == 128) {
    wgmma_n128(d, da, db);
  } else if constexpr (N == 64) {
    wgmma_n64(d, da, db);
  } else {
    wgmma_n32(d, da, db);
  }
}

// No-swizzle K-major operand: 8-row core matrices of 16-byte rows, the
// next 8 K columns `lbo` bytes on, the next 8 rows 128 bytes on.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 128, 0);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box at (c0, c1, c2) of map m <- shared memory at src (async proxy).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* m,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

// Leaky ReLU on the 8 bf16 values of v, each rounded once.
__device__ __forceinline__ uint4 lrelu8(uint4 v, float slope) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(lrelu(f.x, slope), lrelu(f.y, slope));
  }
  return v;
}

struct Bars {
  uint64_t* a_full;
  uint64_t* a_empty;  // arrived on by each consumer warpgroup
  uint64_t* w_full;
  uint64_t* w_empty;  // likewise
  uint64_t* e_full;   // a warpgroup's residual rows in its staging tile
};

template <int BM>
__device__ __forceinline__ void tile_pos(const Args& a, int tile, int& nt,
                                         int& b, int& t0) {
  const int per_n = a.B * a.tiles_b;
  nt = tile / per_n;
  const int r = tile - nt * per_n;
  b = r / a.tiles_b;
  t0 = (r - b * a.tiles_b) * BM;
}

// --- producer: one thread ----------------------------------------------------

// The window of tile `tile` into ring slot ra.st, once the slot is free.
template <int BM>
__device__ __forceinline__ void load_window(const Args& a, uint8_t* A,
                                            const Bars& s, Ring& ra,
                                            int tile) {
  const size_t slot_bytes = (size_t)a.C_in * a.Rs * 2;
  int nt, b, t0;
  tile_pos<BM>(a, tile, nt, b, t0);
  mbar_wait(&s.a_empty[ra.st], ra.ph ^ 1);
  mbar_expect_tx(&s.a_full[ra.st], (int)slot_bytes);
  uint8_t* slot = A + ra.st * slot_bytes;
  for (int c = 0; c < a.C_in / 8; ++c)
    for (int i = 0; i < a.nb; ++i)
      tma_load_3d(slot + ((size_t)c * a.Rs + i * a.Rb) * 16, &a.map_x, c * 8,
                  t0 - a.lo + i * a.Rb, b, &s.a_full[ra.st]);
  ra.next(a.NA);
}

template <int N, int MT>
__device__ void producer(const Args& a, uint8_t* A, uint8_t* W,
                         const Bars& s) {
  constexpr int BM = NWG * 64 * MT, KC = kc_of(N);
  constexpr int STAGE = KC * N * 2;
  const size_t stage_elems = (size_t)KC * N;
  if (a.resident) {  // the whole weight set, once
    for (int i = 0; i < a.S; ++i) {
      mbar_expect_tx(&s.w_full[i], STAGE);
      bulk_load(W + (size_t)i * STAGE, a.w + i * stage_elems, STAGE,
                &s.w_full[i]);
    }
  }
  Ring ra, rw;
  if ((int)blockIdx.x < a.tiles) load_window<BM>(a, A, s, ra, blockIdx.x);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    if (!a.resident) {
      int nt, b, t0;
      tile_pos<BM>(a, tile, nt, b, t0);
      const bf16* w = a.w + (size_t)nt * a.S * stage_elems;
      for (int i = 0; i < a.S; ++i) {
        mbar_wait(&s.w_empty[rw.st], rw.ph ^ 1);
        mbar_expect_tx(&s.w_full[rw.st], STAGE);
        bulk_load(W + (size_t)rw.st * STAGE, w + i * stage_elems, STAGE,
                  &s.w_full[rw.st]);
        rw.next(a.NW);
      }
    }
    // the next tile's window: with two slots it lands while this tile runs
    if (tile + (int)gridDim.x < a.tiles)
      load_window<BM>(a, A, s, ra, tile + gridDim.x);
  }
}

// --- consumers ---------------------------------------------------------------

// The accumulators start at the bias of their columns (or 0): thread q of
// a quad holds columns 8 j + 2 q and 8 j + 2 q + 1 of rows r and r + 8.
template <int N, int MT>
__device__ __forceinline__ void init_acc(float (&acc)[MT][N / 2],
                                         const bf16* __restrict__ bias,
                                         int n0) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float2 bb = make_float2(0.f, 0.f);
    if (bias)
      bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          bias + n0 + 8 * j + 2 * q));
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        acc[m][4 * j + 2 * hr] = bb.x;
        acc[m][4 * j + 2 * hr + 1] = bb.y;
      }
  }
}

// The residual rows of one staging tile: this warpgroup's 64 MT rows of
// tile `tile`, columns n of its half h.  Issued by the warpgroup's first
// thread once the tile's last store has read the staging tile.
template <int N, int MT>
__device__ __forceinline__ void load_res(const Args& a, const Bars& s,
                                         uint8_t* E, int tile, int h) {
  constexpr int BM = NWG * 64 * MT, EN = en_of(N);
  int nt, b, t0;
  tile_pos<BM>(a, tile, nt, b, t0);
  const int wg = threadIdx.x >> 7;
  mbar_expect_tx(&s.e_full[wg], 64 * MT * EN * 2);
  tma_load_3d(E, &a.map_res, nt * N + h * EN, t0 + wg * 64 * MT, b,
              &s.e_full[wg]);
}

// Phase p of tile `tile` -> bf16 out, through this warpgroup's staging
// tile E ([64 MT][EN] row-major): per half of the columns, the f32 terms
// (the accumulators, which started at the bias; activation, residual read
// from E where the tile's load put it, running sum, scale) are rounded
// once into E, and one TMA store writes E's rows (the rows past T are
// clipped).  The warpgroup's first thread then waits for the store to
// read E and loads the next residual rows.
template <int N, int MT>
__device__ __forceinline__ void epilogue(const Args& a, const Bars& s,
                                         uint8_t* E, Ring& re, int tile,
                                         int p, const float (&acc)[MT][N / 2]) {
  constexpr int BM = NWG * 64 * MT, EN = en_of(N);
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int warp = tw >> 5, lane = tid & 31, q = lane & 3;
  int nt, b, t0;
  tile_pos<BM>(a, tile, nt, b, t0);
  const int n0 = nt * N;
  const bf16* __restrict__ sum = a.sum;
#pragma unroll
  for (int h = 0; h < N / EN; ++h) {
    named_sync(2 + wg, 128);  // E's last store has been read
    if (a.has_res) {
      mbar_wait(&s.e_full[wg], re.ph);
      re.next(1);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 64 + warp * 16 + (lane >> 2) + 8 * hr;
        const int t = t0 + wg * 64 * MT + r;
        const size_t g = ((size_t)b * a.T + (t < a.T ? t : 0)) * a.C_out + n0;
#pragma unroll
        for (int jj = 0; jj < EN / 8; ++jj) {
          const int j = h * (EN / 8) + jj, n = 8 * j + 2 * q;
          __nv_bfloat162* e =
              reinterpret_cast<__nv_bfloat162*>(E + (r * EN + n - h * EN) * 2);
          float v0 = acc[mt][4 * j + 2 * hr], v1 = acc[mt][4 * j + 2 * hr + 1];
          if (a.epi_lrelu) {
            v0 = lrelu(v0, SLOPE);
            v1 = lrelu(v1, SLOPE);
          }
          if (a.has_res) {
            const float2 rr = __bfloat1622float2(*e);
            v0 += rr.x;
            v1 += rr.y;
          }
          if (sum && t < a.T) {
            const float2 ss = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sum + g + n));
            v0 += ss.x;
            v1 += ss.y;
          }
          *e = __floats2bfloat162_rn(v0 * a.scale, v1 * a.scale);
        }
      }
    }
    fence_async_shared();  // the staged rows -> the TMA store (async proxy)
    named_sync(2 + wg, 128);
    if (tw == 0) {
      tma_store_3d(&a.map_out, E, p * a.C_out + n0 + h * EN,
                   t0 + wg * 64 * MT, b);
      bulk_wait_read();
      if (a.has_res) {  // the next residual rows: this tile's next half, or
        if (h + 1 < N / EN)  // the next tile's first
          load_res<N, MT>(a, s, E, tile, h + 1);
        else if (tile + (int)gridDim.x < a.tiles)
          load_res<N, MT>(a, s, E, tile + gridDim.x, 0);
      }
    }
  }
}

template <int N, int MT>
__device__ void consumer(const Args& a, uint8_t* A, uint8_t* W, uint8_t* E,
                         const Bars& s) {
  constexpr int KC = kc_of(N);
  constexpr int STAGE = KC * N * 2;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const size_t slot_bytes = (size_t)a.C_in * a.Rs * 2;
  const uint32_t a0 = smem_u32(A), w0 = smem_u32(W);
  const uint32_t lbo_a = (uint32_t)a.Rs * 16;  // the next 8 channels
  const int kchunks = a.C_in / KC;
  Ring ra, rw, re;
  float acc[MT][N / 2];
  if (a.has_res && tw == 0 && (int)blockIdx.x < a.tiles)
    load_res<N, MT>(a, s, E, blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    mbar_wait(&s.a_full[ra.st], ra.ph);
    if (a.pro) {  // the prologue's leaky ReLU, once over the window
      uint4* v = reinterpret_cast<uint4*>(A + ra.st * slot_bytes);
      const int n = (int)(slot_bytes / 16);
      for (int i = tid; i < n; i += NWG * 128) v[i] = lrelu8(v[i], SLOPE);
      // the generic-proxy writes -> the warpgroups' wgmma (async proxy)
      fence_async_shared();
      named_sync(1, NWG * 128);
    }
    const uint32_t slot = a0 + (uint32_t)(ra.st * slot_bytes);
    const int n0 = tile / (a.B * a.tiles_b) * N;  // the tile's columns
    for (int p = 0; p < a.P; ++p) {
      init_acc<N, MT>(acc, a.bias, n0);
      const int shift = p >= a.p_shift ? 1 : 0;
      int held = -1;  // the streamed stage whose group is in flight
      int i = (p * a.taps) * kchunks;
      for (int j = 0; j < a.taps; ++j) {
        const int row = wg * 64 * MT + shift + j * a.d;
        for (int kc = 0; kc < kchunks; ++kc, ++i) {
          const int st = a.resident ? i : rw.st;
          mbar_wait(&s.w_full[st], a.resident ? 0 : rw.ph);
          const uint32_t ws = w0 + st * STAGE;
          const uint32_t ab =
              slot + (uint32_t)(kc * (KC / 8) * a.Rs + row) * 16;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) {
            const uint64_t db = desc_kmajor(ws + ks * 2 * N * 16, N * 16);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_kk<N>(acc[mt],
                          desc_kmajor(ab + ks * 2 * lbo_a + mt * 64 * 16,
                                      lbo_a),
                          db);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (!a.resident) {
            if (held >= 0 && tw == 0) mbar_arrive(&s.w_empty[held]);
            held = rw.st;
            rw.next(a.NW);
          }
        }
      }
      wgmma_wait<0>();
      if (held >= 0 && tw == 0) mbar_arrive(&s.w_empty[held]);
      epilogue<N, MT>(a, s, E, re, tile, p, acc);
    }
    if (tw == 0) mbar_arrive(&s.a_empty[ra.st]);
    ra.next(a.NA);
  }
}

// Up to 64 accumulator registers a thread: room for two blocks an SM.
template <int N, int MT>
__global__ void __launch_bounds__(THREADS, MT * N <= 128 ? 2 : 1)
    vits_conv_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t a_full[MAX_NA], a_empty[MAX_NA];
  __shared__ __align__(8) uint64_t w_full[MAX_NW], w_empty[MAX_NW];
  __shared__ __align__(8) uint64_t e_full[NWG];
  constexpr int E_BYTES = 64 * MT * en_of(N) * 2;
  const int n_stages = a.resident ? a.S : a.NW;
  uint8_t* A = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* W = A + (size_t)a.NA * a.C_in * a.Rs * 2;
  uint8_t* E = W + (size_t)n_stages * kc_of(N) * N * 2;
  const Bars s{a_full, a_empty, w_full, w_empty, e_full};
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.NA; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], NWG);
    }
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], NWG);
    }
    for (int i = 0; i < NWG; ++i) mbar_init(&e_full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NWG * 128) {
    if (threadIdx.x == NWG * 128) producer<N, MT>(a, A, W, s);
  } else {
    consumer<N, MT>(a, A, W, E + (threadIdx.x >> 7) * E_BYTES, s);
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
  }
}

// --- conv_post ---------------------------------------------------------------

// out[b, t] = tanh(sum_j sum_c lrelu(x[b, t - k / 2 + j, c], 0.01) w[j, c])
// in f32; POST_ROWS rows a block (blockIdx.x), batch row blockIdx.y.
__global__ void __launch_bounds__(256)
    vits_post_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int T, int C, int k) {
  extern __shared__ uint8_t smem_raw[];
  const int ld = C + 8;  // bf16 a staged row: 16 bytes of padding
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  float* ws = reinterpret_cast<float*>(smem_raw +
                                       (size_t)(POST_ROWS + k - 1) * ld * 2);
  const int b = blockIdx.y, t0 = blockIdx.x * POST_ROWS, half = k / 2;
  for (int i = threadIdx.x; i < k * C; i += blockDim.x) ws[i] = w[i];
  const int cv = C / 8, rows = POST_ROWS + k - 1;
  for (int i = threadIdx.x; i < rows * cv; i += blockDim.x) {
    const int r = i / cv, c = (i - r * cv) * 8, t = t0 - half + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T)
      v = lrelu8(*reinterpret_cast<const uint4*>(x + ((size_t)b * T + t) * C +
                                                 c),
                 POST_SLOPE);
    *reinterpret_cast<uint4*>(xs + r * ld + c) = v;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < POST_ROWS && t0 + m < T; m += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j)
      for (int c = 0; c < C; c += 8) {
        uint4 v = *reinterpret_cast<const uint4*>(xs + (m + j) * ld + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float* wj = ws + j * C + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          acc = fmaf(f.x, wj[2 * e], acc);
          acc = fmaf(f.y, wj[2 * e + 1], acc);
        }
      }
    out[(size_t)b * T + t0 + m] = tanhf(acc);
  }
}

// --- host --------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int N, int MT>
int launch(const Args& a, size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      vits_conv_kernel<N, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (!sms) return (int)cudaErrorInvalidDevice;
  int per_sm = 0;  // blocks an SM holds at this shared memory
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, vits_conv_kernel<N, MT>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int slots = sms * (per_sm > 1 ? per_sm : 1);
  const int grid = a.tiles < slots ? a.tiles : slots;
  vits_conv_kernel<N, MT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  bf16 tensors, dense and 16-byte
// aligned: x [B, T, C_in], res and sum [B, T, C_out] (or null), out [B, T
// P, C_out], bias [C_out] (or null), w packed by ops/vits_conv.py pack.
// The tile's plan (MT, Rb, nb, NA, NW, resident) is ops/vits_conv.py
// plan; shapes are checked there first.  Each returns 0, a cudaError_t
// after the launch, or minus the CUresult of a refused tensor map.
extern "C" {

size_t t2s_vits_conv_smem_bytes(int C_in, int N, int MT, int Rs, int NA,
                                int n_stages) {
  return conv_smem(C_in, N, MT, Rs, NA, n_stages);
}

int t2s_vits_conv_sm90(const void* x, const void* w, const void* bias,
                       const void* res, const void* sum, void* out, int B,
                       int T, int C_in, int C_out, int taps, int d, int lo,
                       int P, int p_shift, int pro, int epi_lrelu,
                       float scale, int MT, int Rb, int nb, int NA, int NW,
                       int resident, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  const int N = C_out < 256 ? C_out : 256;
  if (!(N == 32 || N == 64 || N == 128 || N == 256) || C_out % N)
    return (int)cudaErrorInvalidValue;
  const int BM = NWG * 64 * MT, KC = kc_of(N), EN = en_of(N);
  a.w = (const bf16*)w;
  a.bias = (const bf16*)bias;
  a.sum = (const bf16*)sum;
  a.has_res = res != nullptr;
  a.B = B; a.T = T; a.C_in = C_in; a.C_out = C_out; a.taps = taps; a.d = d;
  a.lo = lo; a.P = P; a.p_shift = p_shift; a.pro = pro;
  a.epi_lrelu = epi_lrelu; a.scale = scale;
  a.Rb = Rb; a.nb = nb; a.Rs = Rb * nb; a.NA = NA; a.NW = NW;
  a.resident = resident;
  a.S = P * taps * (C_in / KC);
  a.tiles_b = (T + BM - 1) / BM;
  a.tiles = (C_out / N) * B * a.tiles_b;
  const int span = (taps - 1) * d + (p_shift < P ? 1 : 0);
  const int n_stages = resident ? a.S : NW;
  const size_t smem = conv_smem(C_in, N, MT, a.Rs, NA, n_stages);
  if (B < 1 || T < 1 || C_in % KC || taps < 1 || d < 1 || P < 1 ||
      p_shift < 0 || p_shift > P || (P > 1 && (res || sum)) ||
      Rb % 8 || Rb < 8 || Rb > 256 || nb < 1 || a.Rs < BM + span ||
      NA < 1 || NA > MAX_NA || (resident && (a.S > MAX_NW || C_out != N)) ||
      (!resident && (NW < 2 || NW > MAX_NW)) ||
      smem + 8 * (2 * MAX_NA + 2 * MAX_NW + NWG) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  int e;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)C_in, (cuuint64_t)T,
                                (cuuint64_t)B};
    const cuuint64_t str[2] = {(cuuint64_t)C_in * 2, (cuuint64_t)T * C_in * 2};
    const cuuint32_t box[3] = {8, (cuuint32_t)Rb, 1};
    if ((e = encode(&a.map_x, x, 3, dims, str, box, none))) return e;
  }
  const cuuint32_t ebox[3] = {(cuuint32_t)EN, (cuuint32_t)(64 * MT), 1};
  {
    const cuuint64_t W = (cuuint64_t)P * C_out;
    const cuuint64_t dims[3] = {W, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t str[2] = {W * 2, (cuuint64_t)T * W * 2};
    if ((e = encode(&a.map_out, out, 3, dims, str, ebox, none))) return e;
  }
  if (res) {
    const cuuint64_t dims[3] = {(cuuint64_t)C_out, (cuuint64_t)T,
                                (cuuint64_t)B};
    const cuuint64_t str[2] = {(cuuint64_t)C_out * 2,
                               (cuuint64_t)T * C_out * 2};
    if ((e = encode(&a.map_res, res, 3, dims, str, ebox, none))) return e;
  }
  switch (N * 8 + MT) {  // the tiles of ops/vits_conv.py TILES
    case 256 * 8 + 1: return launch<256, 1>(a, smem, stream);
    case 128 * 8 + 2: return launch<128, 2>(a, smem, stream);
    case 128 * 8 + 1: return launch<128, 1>(a, smem, stream);
    case 64 * 8 + 2: return launch<64, 2>(a, smem, stream);
    case 32 * 8 + 4: return launch<32, 4>(a, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// conv_post: x [B, T, C] bf16 (C % 8 == 0, C <= 256), w [k, C] f32, out
// [B, T] f32.
int t2s_vits_conv_post(const void* x, const void* w, void* out, int B, int T,
                       int C, int k, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 8 || C % 8 || C > 256 || k < 1 ||
      k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(POST_ROWS + k - 1) * (C + 8) * 2 + (size_t)k * C * 4;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      vits_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + POST_ROWS - 1) / POST_ROWS, B);
  vits_post_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w, (float*)out, T, C, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
