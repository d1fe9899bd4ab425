// The padded WN layer and its in-kernel-conditioning form, redesigned for
// Hopper (sm_90a): one kernel, two roles.
//
//   SPECT   replaces text2speech_tpu/ops/pallas/wn_block_padded.py:165
//           wn_layer_spect (pallas_call :194, body _kernel_padded,
//           project_cond=True)
//   PADDED  replaces :104 wn_layer_padded (pallas_call :135,
//           _kernel_padded, project_cond=False)
//
// These are oracles: only the parity ladder runs them (chip_smoke.py phase
// 23), where SPECT is held to the stream layer of
// csrc/wn_block_padded_sm90.cu and PADDED to the dcond layer of
// csrc/wn_block_sm90.cu.  A rung proves something only between two
// implementations, so nothing here comes from those files or from
// wn_common.cuh: the role logic, the staging, the K loop, the gate and the
// epilogues are this file's own, and only sm90.cuh's PTX wrappers
// (mbarriers, TMA, descriptors, the tensor-map encoder) are shared.
// csrc/wn_block_padded.cu keeps the first design (f32 FMAs), reachable
// through ops/wn_block_padded.py first_design for timing.
//
// Layout.  Activations are [B, Tp, C] with Tp = T + 2 bt, bt = 128 zero
// rows on each side of the T real rows (ops/wn_block_padded.py pad_tiles):
// every tap row t +- d of a real row is a real address when d <= bt.  For
// each real row t:
//
//   in_act = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b_in + cond
//            SPECT:  cond = spect[t] W_cond + b_cond
//            PADDED: cond = cond_p[t, 2C ci : 2C (ci + 1)]  (b_cond in it)
//   g      = bf16(tanh(in_act[:C]) * sigmoid(in_act[C:]))
//   rs     = g W_rs + b_rs                                  (f32)
//   x_new  = bf16(x + rs[:C])  (x itself when rs_out == C), zero at real
//            rows >= n_valid
//   SPECT:  skip_acc = bf16(skip_acc + bf16(rs[C:])), in place
//   PADDED: skip     = bf16(rs[C:]), a new array
//   (rs whole in place of rs[C:] when rs_out == C; the skip is not masked)
//
// The pad tiles of x_new and of the skip are written as zeros.
//
// What bounds it on an H100.  At B=1, T=6400, C=512, M=640 a SPECT call is
// 2 x 6400 x (2176 + 512) x 1024 = 35.2 GFLOP of bf16 products, 0.0356 ms
// at 989 TFLOP/s (PADDED, without the conditioning's product, 0.0271 ms):
// bound by operations.  The first design ran the products as f32 FMAs on
// the CUDA cores (0.53 ms at best; 3.5 ms measured) in 32-row slabs, staged
// K 32 deep as f32 and read every weight value from shared memory once
// per 4 rows.
//
// Design: the TPU kernel's three neighbour tiles, on the tensor cores.
//
// * Blocks.  A block owns BM = 64 rows of one utterance: one consumer
//   warpgroup and one producer warp, 160 threads.  The grid is persistent:
//   a block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so the
//   producer loads a tile's first stages during the last tile's epilogue;
//   afterwards the blocks share out the pad tiles' zeros.  The host plan
//   (ops/wn_block_padded.py padded_tiles_plan) picks the ring's depth.
// * Taps as three tiles.  For a 64-row tile at t0 and a 64-channel K chunk
//   the producer loads three TMA boxes, x[t0 - d, t0 + 64 - d), x[t0, t0 +
//   64) and x[t0 + d, t0 + 64 + d), each into its own stage with the tap's
//   [64, 128] weight tile (w_in [3C, 2C] stored [K, N], read MN-major): the
//   TPU's BlockSpecs (t-1, t, t+1), read as three tiles.  TMA starts a box
//   at any row, so every tap's A is a shared-memory descriptor at a
//   1024-byte-aligned slot with the 128-byte swizzle; no ldmatrix, no A in
//   registers.  x crosses L2 -> shared memory three times per gate chunk
//   (the stream kernel, row 14, stages one window of 64 + 2d rows).
// * Conditioning.  SPECT: the spect rows [t0, t0 + 64) and w_cond run as
//   further 64-deep K stages into the same accumulators (TMA's zero fill
//   past M).  PADDED: the gate chunk's 64 tanh and 64 sigmoid columns of
//   the layer's slice (cond_off = 2C ci) come into a cond slot by TMA, once
//   the chunk's first ring-full of stages is queued, and are added in the
//   gate.
// * Gate chunks are 64 tanh + 64 sigmoid columns (wgmma m64n128k16), so C
//   % 128 == 64 needs no half chunk.  Accumulator tile j (8 columns) and
//   tile j + 8 are a column and its gate partner in one thread's
//   registers; the gate runs in f32 (the sigmoid as 0.5 tanh(x / 2) + 0.5)
//   and writes bf16 into the gated tile [64, C] in shared memory:
//   64-column panels, 128-byte swizzle, wgmma's K-major A.
// * Res/skip.  [64, C] x [C, rs_out] in chunks of 128 columns, A from the
//   gated tile.  The epilogue reads x (and SPECT's skip sum) for a group
//   of 8 column tiles before it stores any of them; SPECT's sum is read and
//   written only by the block that owns those rows.
// * One ring.  A stage is 24 KB: an [64, 64] A box and a [64, 128] weight
//   tile (the res/skip stages fill the weight part only), full / empty
//   mbarriers.  Every group reads both operands from shared memory, so one
//   group stays in flight: a stage is freed once the next group is issued
//   and the older one has completed.  Accumulator indices are all static.
//   A wait that does not complete within seconds traps (sm90.cuh).
//
// Measured times are in PERF.md (rows 12-13).

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;               // rows of a block: one warpgroup
constexpr int KC = 64;               // K per stage: one 128-byte bf16 row
constexpr int GW = 64;               // gate chunk: 64 tanh + 64 sigmoid
constexpr int NT = 2 * GW;           // wgmma N
constexpr int ABOX = BM * KC * 2;    // one tap's [64 rows, 64 K] A box
constexpr int WBOX = KC * 64 * 2;    // one [64 K, 64 N] weight box, bytes
constexpr int STAGE = ABOX + 2 * WBOX;  // a ring stage: A box + N = 128
constexpr int CSLOT = 2 * BM * GW * 2;  // PADDED: a chunk's cond columns
constexpr int MAX_ST = 8;

enum TilesRole { SPECT = 0, PADDED = 1 };

// Dynamic shared memory: the gated tile, PADDED's cond slot and the ring,
// after 1 KB of alignment slack.
__host__ __device__ inline size_t tiles_smem(int role, int C, int nst) {
  return 1024 + (size_t)BM * C * 2 + (role == PADDED ? CSLOT : 0) +
         (size_t)nst * STAGE;
}

struct Args {
  CUtensorMap map_x;      // x [B, Tp, C]; box {64, BM, 1}
  CUtensorMap map_cond;   // SPECT: spect [B, Tp, M]; PADDED: cond_p
                          // [B, Tp, 2C n_cond]; box {64, BM, 1}
  CUtensorMap map_win;    // w_in as [3C, 2C]; box {64, 64}
  CUtensorMap map_wcond;  // SPECT: w_cond [M, 2C]; box {64, 64}
  CUtensorMap map_wrs;    // w_rs [C, rs_out]; box {64, 64}
  const bf16* x;
  const float* b_in;
  const float* b_cond;    // SPECT
  const float* b_rs;
  bf16* skip;             // SPECT: skip_acc, in place; PADDED: the output
  bf16* x_out;
  int B, Tp, bt, T, n_valid, C, M, rs_out, d, cond_off;
  int nst, tiles;         // ring depth; B T / BM row tiles
};

// --- PTX: the shared-memory wgmma m64n128k16 and a named barrier -----------

#define TL_ACC_TEXT                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                \
  "%8, %9, %10, %11, %12, %13, %14, %15,"           \
  "%16, %17, %18, %19, %20, %21, %22, %23,"         \
  "%24, %25, %26, %27, %28, %29, %30, %31,"         \
  "%32, %33, %34, %35, %36, %37, %38, %39,"         \
  "%40, %41, %42, %43, %44, %45, %46, %47,"         \
  "%48, %49, %50, %51, %52, %53, %54, %55,"         \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define TL_ACC_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),    \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),    \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),    \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),    \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64] += A (shared memory, K-major) x B (shared memory, MN-major).  d:
// column tile j (8 columns) in d[4j..4j+3], rows lane/4 (d[4j], d[4j+1])
// and lane/4 + 8 of the warp's 16, columns 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TL_ACC_TEXT
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : TL_ACC_OPS(d)
      : "l"(da), "l"(db), "r"(1));
}

// 64 rows of 128 bytes with the 128-byte swizzle (a tap box, a spect box,
// a gated-tile panel): K-major A, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_rows_k(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}
// A weight tile: two [64 K, 64 N] boxes WBOX apart, 128-byte rows of N.
__device__ __forceinline__ uint64_t desc_w_pair(uint32_t addr) {
  return make_desc(addr, WBOX, 1024, 1);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of (row r, column c) in 64-column panels of BM rows x 128
// bytes, 16-byte chunks XORed with the row's low bits (TMA's 128-byte
// swizzle; the gated tile and the cond slot).
__device__ __forceinline__ uint32_t swz_off(int r, int c) {
  return (uint32_t)((c >> 6) * (BM * 128) + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float tanh_sigmoid(float at, float as) {
  return tanhf(at) * fmaf(0.5f, tanhf(0.5f * as), 0.5f);
}

struct Stages {
  uint8_t* ring;        // nst stages of STAGE bytes
  uint8_t* cond;        // PADDED: CSLOT bytes
  uint64_t* full;
  uint64_t* empty;
  uint64_t* cond_full;
  uint64_t* cond_empty;  // arrived on by the 128 consumer threads
};

// --- producer: one thread of the producer warp ----------------------------

// Waits for ring slot r.st and expects `bytes` on its full barrier; returns
// the slot.
__device__ __forceinline__ uint8_t* claim(const Stages& s, const Ring& r,
                                          int bytes) {
  mbar_wait(&s.empty[r.st], r.ph ^ 1);
  mbar_expect_tx(&s.full[r.st], bytes);
  return s.ring + (size_t)r.st * STAGE;
}

// The two [64 K, 64 N] boxes of map m at columns n0, n1, K rows k0.. into
// the weight part of `slot`.
__device__ __forceinline__ void load_w_pair(uint8_t* slot, const CUtensorMap* m,
                                            int n0, int n1, int k0,
                                            uint64_t* bar) {
  tma_load_2d(slot + ABOX, m, n0, k0, bar);
  tma_load_2d(slot + ABOX + WBOX, m, n1, k0, bar);
}

template <int ROLE>
__device__ void producer_loop(const Args& a, const Stages& s) {
  const int per_b = a.T / BM, C = a.C;
  const int per_chunk = 3 * (C / KC) + (ROLE == SPECT ? (a.M + KC - 1) / KC : 0);
  // PADDED: a chunk's cond columns load once its first ring-full of stages
  // is queued, by which time the last chunk's gate has freed the slot
  const int cond_at = (a.nst < per_chunk ? a.nst : per_chunk) - 1;
  Ring r, rc;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b = tile / per_b, t0 = a.bt + (tile % per_b) * BM;
    for (int c0 = 0; c0 < C; c0 += GW) {
      int i = 0;
      for (int k0 = 0; k0 < C; k0 += KC) {
        for (int j = 0; j < 3; ++j, ++i) {  // tap j: rows t0 + (j - 1) d
          uint8_t* slot = claim(s, r, STAGE);
          tma_load_3d(slot, &a.map_x, k0, t0 + (j - 1) * a.d, b,
                      &s.full[r.st]);
          load_w_pair(slot, &a.map_win, c0, C + c0, j * C + k0,
                      &s.full[r.st]);
          r.next(a.nst);
          if (ROLE == PADDED && i == cond_at) {
            mbar_wait(s.cond_empty, rc.ph ^ 1);
            mbar_expect_tx(s.cond_full, CSLOT);
            tma_load_3d(s.cond, &a.map_cond, a.cond_off + c0, t0, b,
                        s.cond_full);
            tma_load_3d(s.cond + BM * 128, &a.map_cond, a.cond_off + C + c0,
                        t0, b, s.cond_full);
            rc.next(1);
          }
        }
      }
      if (ROLE == SPECT) {
        for (int k0 = 0; k0 < a.M; k0 += KC) {  // past M: zero fill
          uint8_t* slot = claim(s, r, STAGE);
          tma_load_3d(slot, &a.map_cond, k0, t0, b, &s.full[r.st]);
          load_w_pair(slot, &a.map_wcond, c0, C + c0, k0, &s.full[r.st]);
          r.next(a.nst);
        }
      }
    }
    for (int n0 = 0; n0 < a.rs_out; n0 += NT)  // past rs_out: zero fill
      for (int k0 = 0; k0 < C; k0 += KC) {
        uint8_t* slot = claim(s, r, 2 * WBOX);
        load_w_pair(slot, &a.map_wrs, n0, n0 + 64, k0, &s.full[r.st]);
        r.next(a.nst);
      }
  }
}

// --- consumers ---------------------------------------------------------------

// The consumer's place in the ring and the stage whose group is in flight.
struct Pipe {
  const Stages& s;
  Ring r;
  int in_flight;
  int tid;

  __device__ __forceinline__ void release(int st) const {
    if (tid == 0 && st >= 0) mbar_arrive(&s.empty[st]);
  }
  // One stage's group: four wgmma over K = 64, A the stage's own box
  // (FROM_STAGE) or the gated-tile panel at `a_addr`, B the stage's weight
  // tile.  The group before it completes and its stage is freed; this one
  // stays in flight.
  template <bool FROM_STAGE>
  __device__ __forceinline__ void group(float (&acc)[64], uint32_t a_addr) {
    mbar_wait(&s.full[r.st], r.ph);
    const uint32_t slot = smem_u32(s.ring + (size_t)r.st * STAGE);
    const uint32_t pa = FROM_STAGE ? slot : a_addr;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_m64n128(acc, desc_rows_k(pa + ks * 32),
                       desc_w_pair(slot + ABOX + ks * 2048));
    wgmma_commit();
    wgmma_wait<1>();
    release(in_flight);
    in_flight = r.st;
  }
  __device__ __forceinline__ void settle() {
    wgmma_wait<0>();
    release(in_flight);
    in_flight = -1;
  }
};

__device__ __forceinline__ void clear(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// The in-act product of one gate chunk: three tap stages per K chunk of x,
// then (SPECT) the conditioning's stages.
template <int ROLE>
__device__ __forceinline__ void inact_product(const Args& a, Pipe& p,
                                              float (&acc)[64]) {
  clear(acc);
  const int n = 3 * (a.C / KC) + (ROLE == SPECT ? (a.M + KC - 1) / KC : 0);
  for (int i = 0; i < n; ++i) {
    p.group<true>(acc, 0);
    p.r.next(a.nst);
  }
  p.settle();
}

// Gate chunk c0: tile j (tanh columns c0 + 8j + 2q + {0, 1}) with tile
// j + 8 (their sigmoid partners), rows r0 and r0 + 8 -> the gated tile.
// PADDED adds the chunk's cond columns from the cond slot (tanh columns in
// its first panel, sigmoid in its second).
template <int ROLE>
__device__ __forceinline__ void apply_gate(const Args& a, int c0, int r0,
                                           const float (&acc)[64], uint8_t* G,
                                           const uint8_t* cs) {
  const int q = threadIdx.x & 3, C = a.C;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lc = 8 * j + 2 * q, c = c0 + lc;
    float2 bt = *reinterpret_cast<const float2*>(a.b_in + c);
    float2 bs = *reinterpret_cast<const float2*>(a.b_in + C + c);
    if (ROLE == SPECT) {
      const float2 ct = *reinterpret_cast<const float2*>(a.b_cond + c);
      const float2 cg = *reinterpret_cast<const float2*>(a.b_cond + C + c);
      bt = make_float2(bt.x + ct.x, bt.y + ct.y);
      bs = make_float2(bs.x + cg.x, bs.y + cg.y);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int i = 4 * j + 2 * h, k = 4 * (j + 8) + 2 * h;
      float t0 = acc[i] + bt.x, t1 = acc[i + 1] + bt.y;
      float s0 = acc[k] + bs.x, s1 = acc[k + 1] + bs.y;
      if (ROLE == PADDED) {
        const __nv_bfloat162 ct =
            *reinterpret_cast<const __nv_bfloat162*>(cs + swz_off(row, lc));
        const __nv_bfloat162 cg = *reinterpret_cast<const __nv_bfloat162*>(
            cs + swz_off(row, GW + lc));
        t0 += __low2float(ct);
        t1 += __high2float(ct);
        s0 += __low2float(cg);
        s1 += __high2float(cg);
      }
      *reinterpret_cast<__nv_bfloat162*>(G + swz_off(row, c)) =
          __floats2bfloat162_rn(tanh_sigmoid(t0, s0), tanh_sigmoid(t1, s1));
    }
  }
}

// One res/skip chunk (128 columns) for the block's 64 rows: A from the
// gated tile's panels, B from the ring.
__device__ __forceinline__ void rs_product(const Args& a, Pipe& p,
                                           const uint8_t* G,
                                           float (&acc)[64]) {
  const uint32_t g0 = smem_u32(G);
  clear(acc);
  for (int k0 = 0; k0 < a.C; k0 += KC) {
    p.group<false>(acc, g0 + (k0 >> 6) * (BM * 128));
    p.r.next(a.nst);
  }
  p.settle();
}

// The residual (zero at real rows >= n_valid) and the skip (SPECT: summed
// in place; PADDED: written) for rows t[0], t[1] of this thread at columns
// n0 + 8j + 2q, in two groups of 8 column tiles, each group's loads before
// its stores.
template <int ROLE>
__device__ __forceinline__ void store_rows(const Args& a, int b,
                                           const int (&t)[2], int n0,
                                           const float (&acc)[64]) {
  const int q = threadIdx.x & 3, C = a.C;
  const bool has_res = a.rs_out == 2 * C;
  bool ok[2];
  size_t row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ok[h] = t[h] - a.bt < a.n_valid;
    row[h] = ((size_t)b * a.Tp + t[h]) * C;
  }
#pragma unroll
  for (int jg = 0; jg < 16; jg += 8) {
    float2 bias[8];
    __nv_bfloat162 in[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + 8 * (jg + jj) + 2 * q;
      bias[jj] = make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) in[jj][h] = __floats2bfloat162_rn(0.f, 0.f);
      if (n >= a.rs_out) continue;
      bias[jj] = *reinterpret_cast<const float2*>(a.b_rs + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (has_res && n < C) {
          if (ok[h])
            in[jj][h] =
                *reinterpret_cast<const __nv_bfloat162*>(a.x + row[h] + n);
        } else if (ROLE == SPECT) {
          in[jj][h] = *reinterpret_cast<const __nv_bfloat162*>(
              a.skip + row[h] + (has_res ? n - C : n));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = jg + jj, n = n0 + 8 * j + 2 * q;
      if (n >= a.rs_out) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + bias[jj].x;
        const float v1 = acc[4 * j + 2 * h + 1] + bias[jj].y;
        const float i0 = __low2float(in[jj][h]), i1 = __high2float(in[jj][h]);
        if (has_res && n < C) {
          *reinterpret_cast<__nv_bfloat162*>(a.x_out + row[h] + n) =
              ok[h] ? __floats2bfloat162_rn(i0 + v0, i1 + v1)
                    : __floats2bfloat162_rn(0.f, 0.f);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.skip + row[h] +
                                             (has_res ? n - C : n)) =
              ROLE == SPECT ? __floats2bfloat162_rn(i0 + round_bf16(v0),
                                                    i1 + round_bf16(v1))
                            : __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int ROLE>
__device__ void consumer_loop(const Args& a, const Stages& s, uint8_t* G) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int per_b = a.T / BM;
  Pipe p{s, Ring(), -1, tid};
  Ring rc;
  float acc[64];
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b = tile / per_b, t0 = a.bt + (tile % per_b) * BM;
    const int t[2] = {t0 + r0, t0 + r0 + 8};
    for (int c0 = 0; c0 < a.C; c0 += GW) {
      inact_product<ROLE>(a, p, acc);
      if (ROLE == PADDED) mbar_wait(s.cond_full, rc.ph);
      apply_gate<ROLE>(a, c0, r0, acc, G, s.cond);
      if (ROLE == PADDED) {
        mbar_arrive(s.cond_empty);
        rc.next(1);
      }
    }
    // the gated rows -> the warpgroup's wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1, 128);
    for (int n0 = 0; n0 < a.rs_out; n0 += NT) {
      rs_product(a, p, G, acc);
      store_rows<ROLE>(a, b, t, n0, acc);
    }
    if (a.rs_out == a.C) {  // skip only: the hidden state passes, masked
      const int cv = a.C / 8;
      for (int i = tid; i < BM * cv; i += 128) {
        const int tt = t0 + i / cv;
        const size_t o = ((size_t)b * a.Tp + tt) * a.C + (i % cv) * 8;
        *reinterpret_cast<uint4*>(a.x_out + o) =
            tt - a.bt < a.n_valid ? *reinterpret_cast<const uint4*>(a.x + o)
                                  : make_uint4(0, 0, 0, 0);
      }
    }
  }
  // the pad tiles of both outputs: zeros, a grid-stride share of them
  const int nthreads = gridDim.x * 128;
  const int cv = a.C / 8, pad_rows = a.B * 2 * a.bt;
  for (int i = blockIdx.x * 128 + tid; i < pad_rows * cv; i += nthreads) {
    const int pr = i / cv, b = pr / (2 * a.bt), r = pr % (2 * a.bt);
    const int tt = r < a.bt ? r : a.Tp - 2 * a.bt + r;
    const size_t o = ((size_t)b * a.Tp + tt) * a.C + (i % cv) * 8;
    *reinterpret_cast<uint4*>(a.x_out + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(a.skip + o) = make_uint4(0, 0, 0, 0);
  }
}

template <int ROLE>
__global__ void __launch_bounds__(160, 1)
    wn_tiles_sm90_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_ST], empty[MAX_ST];
  __shared__ __align__(8) uint64_t cond_full, cond_empty;
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  uint8_t* G = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Stages s;
  s.cond = G + (size_t)BM * a.C * 2;
  s.ring = s.cond + (ROLE == PADDED ? CSLOT : 0);
  s.full = full;
  s.empty = empty;
  s.cond_full = &cond_full;
  s.cond_empty = &cond_empty;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_init(&cond_full, 1);
    mbar_init(&cond_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // the producer warp: one thread loads
    if (threadIdx.x == 128) producer_loop<ROLE>(a, s);
  } else {
    consumer_loop<ROLE>(a, s, G);
  }
}

// --- host -------------------------------------------------------------------

// The five tensor maps; `cond` is spect [B, Tp, M] (SPECT) or cond_p [B,
// Tp, W] (PADDED), `cond_w` its width.
int encode_tiles(Args& a, int role, const void* x, const void* cond,
                 int cond_w, const void* w_in, const void* w_cond,
                 const void* w_rs) {
  const cuuint64_t B = a.B, Tp = a.Tp, C = a.C;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint32_t abox[3] = {64, (cuuint32_t)BM, 1};
  const cuuint32_t wbox[2] = {64, 64};
  int e;
  {
    const cuuint64_t dims[3] = {C, Tp, B};
    const cuuint64_t str[2] = {C * 2, Tp * C * 2};
    if ((e = encode(&a.map_x, x, 3, dims, str, abox, sw))) return e;
  }
  {
    const cuuint64_t W = (cuuint64_t)cond_w;
    const cuuint64_t dims[3] = {W, Tp, B};
    const cuuint64_t str[2] = {W * 2, Tp * W * 2};
    if ((e = encode(&a.map_cond, cond, 3, dims, str, abox, sw))) return e;
  }
  {
    const cuuint64_t dims[2] = {2 * C, 3 * C};
    const cuuint64_t str[1] = {2 * C * 2};
    if ((e = encode(&a.map_win, w_in, 2, dims, str, wbox, sw))) return e;
  }
  if (role == SPECT) {
    const cuuint64_t dims[2] = {2 * C, (cuuint64_t)a.M};
    const cuuint64_t str[1] = {2 * C * 2};
    if ((e = encode(&a.map_wcond, w_cond, 2, dims, str, wbox, sw))) return e;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.rs_out, C};
  const cuuint64_t str[1] = {(cuuint64_t)a.rs_out * 2};
  return encode(&a.map_wrs, w_rs, 2, dims, str, wbox, sw);
}

template <int ROLE>
int launch_tiles(const Args& a, void* stream) {
  const size_t smem = tiles_smem(ROLE, a.C, a.nst);
  cudaError_t e = cudaFuncSetAttribute(
      wn_tiles_sm90_kernel<ROLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.tiles < sms ? a.tiles : sms;
  wn_tiles_sm90_kernel<ROLE><<<grid, 160, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Fills the shapes and the plan; returns false on what the kernel refuses.
bool fill_tiles(Args& a, int B, int Tp, int bt, int n_valid, int C, int M,
                int rs_out, int d, int nst) {
  memset(&a, 0, sizeof(a));
  a.B = B; a.Tp = Tp; a.bt = bt; a.T = Tp - 2 * bt; a.n_valid = n_valid;
  a.C = C; a.M = M; a.rs_out = rs_out; a.d = d; a.nst = nst;
  a.tiles = B * (a.T / BM);
  return B >= 1 && bt % BM == 0 && a.T > 0 && a.T % BM == 0 && C > 0 &&
         C % 64 == 0 && M >= 0 && M % 32 == 0 && d >= 0 && d <= bt &&
         n_valid >= 0 && n_valid <= a.T && (rs_out == C || rs_out == 2 * C) &&
         nst >= 2 && nst <= MAX_ST;
}

}  // namespace

// Plain C interface (loaded with ctypes).  bf16 activations and weights,
// f32 biases, all dense and 16-byte aligned: x, spect, skip [B, Tp, .],
// cond_p [B, Tp, 2C n_cond], w_in [3, C, 2C], w_cond [M, 2C], w_rs [C,
// rs_out].  `nst` (the ring's depth) is the plan of ops/wn_block_padded.py;
// shapes are checked there first.  Each returns 0, a cudaError_t after the
// launch, or minus the CUresult of a refused tensor map.
extern "C" {

// `role`: 0 SPECT, 1 PADDED
size_t t2s_wn_padded_tiles_sm90_smem_bytes(int role, int C, int nst) {
  return tiles_smem(role, C, nst);
}

int t2s_wn_spect_tiles_sm90(const void* x, const void* spect,
                            const void* w_in, const void* b_in,
                            const void* w_cond, const void* b_cond,
                            const void* w_rs, const void* b_rs, void* skip,
                            void* x_out, int B, int Tp, int bt, int n_valid,
                            int C, int M, int rs_out, int d, int nst,
                            void* stream) {
  Args a;
  if (!fill_tiles(a, B, Tp, bt, n_valid, C, M, rs_out, d, nst) || M == 0)
    return (int)cudaErrorInvalidValue;
  a.x = (const bf16*)x;
  a.b_in = (const float*)b_in;
  a.b_cond = (const float*)b_cond;
  a.b_rs = (const float*)b_rs;
  a.skip = (bf16*)skip;
  a.x_out = (bf16*)x_out;
  const int e = encode_tiles(a, SPECT, x, spect, M, w_in, w_cond, w_rs);
  if (e) return e;
  return launch_tiles<SPECT>(a, stream);
}

int t2s_wn_padded_tiles_sm90(const void* x, const void* cond,
                             const void* w_in, const void* b_in,
                             const void* w_rs, const void* b_rs,
                             void* x_out, void* skip_out, int B, int Tp,
                             int bt, int n_valid, int C, int n_cond,
                             int cond_index, int rs_out, int d, int nst,
                             void* stream) {
  Args a;
  if (!fill_tiles(a, B, Tp, bt, n_valid, C, 0, rs_out, d, nst) ||
      n_cond < 1 || cond_index < 0 || cond_index >= n_cond)
    return (int)cudaErrorInvalidValue;
  a.x = (const bf16*)x;
  a.b_in = (const float*)b_in;
  a.b_rs = (const float*)b_rs;
  a.skip = (bf16*)skip_out;
  a.x_out = (bf16*)x_out;
  a.cond_off = 2 * C * cond_index;
  const int e =
      encode_tiles(a, PADDED, x, cond, 2 * C * n_cond, w_in, nullptr, w_rs);
  if (e) return e;
  return launch_tiles<PADDED>(a, stream);
}

}  // extern "C"
