// The padded streaming WN layer and its final form, redesigned for Hopper
// (sm_90a): one kernel, two roles.
//
//   STREAM        replaces text2speech_tpu/ops/pallas/wn_block_padded.py:302
//                 wn_layer_stream (pallas_call :334, body _kernel_stream,
//                 final=False)
//   STREAM_FINAL  replaces :353 wn_layer_stream_final (pallas_call :392,
//                 _kernel_stream, final=True)
//
// These are oracles: only the parity ladder runs them (chip_smoke.py phase
// 23), where they check the serving kernels of csrc/wn_block_sm90.cu.  So
// nothing here comes from that file or from wn_common.cuh: the role logic,
// the window staging, the K loop, the gate, the epilogues, the in-place
// skip sum and the end projection are this file's own, and only sm90.cuh's
// PTX wrappers (mbarriers, TMA, descriptors, the tensor-map encoder) are
// shared.  csrc/wn_block_padded.cu keeps the first design (f32 FMAs),
// reachable through ops/wn_block_padded.py first_design for timing.
//
// Layout.  Activations are [B, Tp, C] with Tp = T + 2 bt, bt = 128 zero
// rows on each side of the T real rows (ops/wn_block_padded.py pad_tiles);
// every tap row t +- d of a real row is a real address, so nothing is
// zero-filled or bounds-tested for the taps.  For each real row t:
//
//   in_act = x[t-d] W0 + x[t] W1 + x[t+d] W2 + spect[t] Wc + b_in + b_cond
//   g      = bf16(tanh(in_act[:C]) * sigmoid(in_act[C:]))
//   rs     = g W_rs + b_rs                                  (f32)
//   STREAM:       x_new = bf16(x + rs[:C])  (x itself when rs_out == C),
//                 zero at real rows >= n_valid;
//                 skip  = bf16(skip + bf16(rs[C:]))  (rs whole when rs_out
//                 == C), in place, not masked
//   STREAM_FINAL: wn_out = bf16(f32(skip) + rs) @ w_end + b_end  [E <= 8]
//                 f32, not masked; w_rs is [C, C]; the skip sum is rounded
//                 to bf16 before the end projection (nothing is folded)
//
// The pad tiles of x_new, the skip sum and wn_out are written as zeros.
//
// What bounds it on an H100.  At B=1, T=6400, C=512, M=640 a STREAM call is
// 2 x 6400 x (2176 + 512) x 1024 = 35.2 GFLOP of bf16 products against
// ~30 MB of activations and 5.3 MB of weights: 0.0356 ms at 989 TFLOP/s,
// bound by operations (STREAM_FINAL 0.0323 ms).  The first design ran its
// products as f32 FMAs on the CUDA cores (0.53 ms at best; 7.0 ms
// measured), staged K 32 deep as f32, and read every weight value from
// shared memory once per row.
//
// Design: read x once per K chunk, on the tensor cores.
//
// * Blocks.  A block owns BM = 64 rows of one utterance: one consumer
//   warpgroup and one producer warp, 160 threads, no register
//   reallocation.  The grid is persistent: a block walks the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... (a loop inside the block, not
//   the TPU's one-tile-behind grid: nothing carries over between tiles but
//   the rings' phases), so the producer loads the next tile's first stages
//   during the last tile's epilogue.  The host plan
//   (ops/wn_block_padded.py padded_sm90_plan) picks the ring depths.
// * Window staging.  For each 64-channel K chunk of x the producer loads
//   the rows [t0 - d, t0 + BM + d) once, by TMA (one box, or two where BM +
//   2d > 256), into a window slot with the 128-byte swizzle.  The three
//   taps are that one window at row offsets 0, d and 2d: wgmma with A in
//   registers, each warp's fragments loaded by ldmatrix at any row offset
//   (a shared-memory descriptor cannot start at a row that is not a
//   multiple of 8), honouring the swizzle.  B is the tap's [64, 128] weight
//   tile, w_in [3C, 2C] stored [K, N] and read MN-major.  x crosses L2 ->
//   shared memory 1 + 2d/BM times per gate chunk, not 3.
// * Conditioning.  The spect rows [t0, t0 + BM) and w_cond run as further
//   K stages (a window slot's first BM rows, TMA's zero fill past M), with
//   A from shared memory.
// * Gate chunks are 64 tanh + 64 sigmoid columns (wgmma N = 128; the
//   serving kernel's are 128 + 128), so C % 128 == 64 needs no half chunk.
//   Accumulator tile j (8 columns) and tile j + 8 are a column and its
//   gate partner in one thread's registers; the gate runs in f32 (the
//   sigmoid as 0.5 tanh(x / 2) + 0.5) and writes bf16 into the gated tile
//   [BM, C] in shared memory: 64-column panels, 128-byte swizzle, wgmma's
//   K-major A.
// * Res/skip.  The product [BM, C] x [C, rs_out] runs in chunks of 128
//   columns, A from the gated tile.  STREAM's epilogue adds the residual
//   (masked at n_valid) and sums the skip in place: each block reads and
//   writes its own rows only, every load of a group of 8 column tiles
//   issued before its stores.  STREAM_FINAL rounds bf16(skip + rs) in
//   registers and accumulates each row's E partial sums across its column
//   chunks as FMAs against w_end (staged once in shared memory, zero past
//   E); the four threads of a quad, which share two rows, meet by shuffles.
// * Rings.  Window slots (1-2) and weight slots (2-4, [64, 128] bf16 each)
//   are two rings guarded by full / empty mbarriers.  A tap group (one
//   tap's four wgmma, A in registers) is retired before the next tap's
//   fragments are loaded: ptxas serializes every wgmma of a kernel in
//   which an ldmatrix writes a wgmma's registers while a group is in
//   flight.  The conditioning's and the res/skip product's groups (A in
//   shared memory) keep one group in flight and free a group's slots once
//   the next one is issued and the older one has completed; a single
//   window slot is freed as soon as its last group completes.  A wait
//   that does not complete within seconds traps (sm90.cuh).
//
// What remains.  A 64-row tile uses a 16 KB weight stage for 1 MFLOP (64
// FLOP a byte), and every tile streams all of the layer's weights (5.5 MB
// at C = 512, M = 640) and its x windows and spect rows (2.2 MB at d =
// 64) from L2: at B=1 that is 0.77 GB of L2 reads for 35 GFLOP.  Whether
// those reads or the per-group drains set the time is not measured (no
// kernel profiler on the machine); a cluster that multicasts the weight
// stages would halve them.
//
// Alternatives timed on an H100 (PERF.md, rows 14-15): the tap groups
// kept in flight as the other groups are (ptxas serialized every wgmma:
// slower at batch 1 and 3); one group of all three taps' twelve wgmma per
// K chunk (about as fast, and it needs three weight slots at once);
// 128-row blocks of two consumer warpgroups, the alternative that lost
// (slower at batch 1, as fast or slower at batch 3: a 230 KB block leaves
// room for two weight slots only, and 50 blocks of 128 rows do not fill
// 132 SMs), so BM is 64.
//
// Measured times are in PERF.md (rows 14-15).

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;               // rows of a block: one warpgroup
constexpr int KC = 64;               // K per stage: one 128-byte bf16 row
constexpr int GW = 64;               // gate chunk: 64 tanh + 64 sigmoid
constexpr int NT = 2 * GW;           // wgmma N
constexpr int WBOX = KC * 64 * 2;    // one [64 K, 64 N] weight box, bytes
constexpr int WSLOT = 2 * WBOX;      // a weight stage: two boxes, N = 128
constexpr int MAX_WIN = 2;
constexpr int MAX_WST = 4;
constexpr int E_PAD = 8;             // w_end staged as [C, 8] bf16
constexpr int MAX_BOX_ROWS = 256;    // TMA's largest box extent

enum PaddedRole { STREAM = 0, STREAM_FINAL = 1 };

// A window slot: nb boxes of h rows (h % 8 == 0) covering BM + 2d rows.
struct Window {
  int nb, h;
  __host__ __device__ int bytes() const { return nb * h * 128; }
};

__host__ __device__ inline Window window_of(int d) {
  const int rows = BM + 2 * d;
  Window w;
  w.nb = rows > MAX_BOX_ROWS ? 2 : 1;
  w.h = ((rows + w.nb - 1) / w.nb + 7) / 8 * 8;
  return w;
}

// Dynamic shared memory: the gated tile, the window ring, the weight ring
// and (STREAM_FINAL) w_end, after 1 KB of alignment slack.
__host__ __device__ inline size_t padded_smem(int role, int C, int d,
                                              int nwin, int nwst) {
  return 1024 + (size_t)BM * C * 2 + (size_t)nwin * window_of(d).bytes() +
         (size_t)nwst * WSLOT +
         (role == STREAM_FINAL ? (size_t)C * E_PAD * 2 : 0);
}

struct Args {
  CUtensorMap map_x;      // x [B, Tp, C]; box {64, win.h, 1}
  CUtensorMap map_spect;  // spect [B, Tp, M]; box {64, BM, 1}
  CUtensorMap map_win;    // w_in as [3C, 2C]; box {64, 64}
  CUtensorMap map_wcond;  // w_cond [M, 2C]; box {64, 64}
  CUtensorMap map_wrs;    // w_rs [C, rs_out]; box {64, 64}
  const bf16* x;
  const float* b_in;
  const float* b_cond;
  const float* b_rs;
  bf16* skip;             // [B, Tp, C]: STREAM updates it, FINAL reads it
  bf16* x_out;            // STREAM
  const bf16* w_end;      // STREAM_FINAL: [C, E]
  const float* b_end;     // STREAM_FINAL: [E]
  float* out;             // STREAM_FINAL: [B, Tp, E]
  int B, Tp, bt, T, n_valid, C, M, rs_out, E, d;
  Window win;
  int nwin, nwst, tiles;  // ring depths; B T / BM row tiles
};

// --- PTX: ldmatrix and the two wgmma m64n128k16 forms ----------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

#define PS_ACC_TEXT                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                \
  "%8, %9, %10, %11, %12, %13, %14, %15,"           \
  "%16, %17, %18, %19, %20, %21, %22, %23,"         \
  "%24, %25, %26, %27, %28, %29, %30, %31,"         \
  "%32, %33, %34, %35, %36, %37, %38, %39,"         \
  "%40, %41, %42, %43, %44, %45, %46, %47,"         \
  "%48, %49, %50, %51, %52, %53, %54, %55,"         \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define PS_ACC_OPS(d)                                                     \
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

// d[64] += A (this warp's 16 rows x 16 K in registers, the mma.m16n8k16 A
// fragment) x B (shared memory, MN-major).  d: column tile j (8 columns)
// in d[4j..4j+3], rows lane/4 (d[4j], d[4j+1]) and lane/4 + 8, columns
// 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PS_ACC_TEXT
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : PS_ACC_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (shared memory, K-major) x B (shared memory, MN-major)
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PS_ACC_TEXT
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : PS_ACC_OPS(d)
      : "l"(da), "l"(db), "r"(1));
}

// A tile of 128-byte rows with the 128-byte swizzle (a window slot's spect
// rows, a gated-tile panel): K-major, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t a_rows128(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}
// A weight stage: two [64 K, 64 N] boxes WBOX apart, 128-byte rows of N.
__device__ __forceinline__ uint64_t b_stage(uint32_t addr) {
  return make_desc(addr, WBOX, 1024, 1);
}

__device__ __forceinline__ void wg_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of (row r, column c) in the gated tile of BM rows: 64-column
// panels of BM x 128 bytes, 16-byte chunks XORed with the row's low bits.
__device__ __forceinline__ uint32_t gtile_off(int r, int c) {
  return (uint32_t)((c >> 6) * (BM * 128) + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gate_value(float at, float as) {
  return tanhf(at) * fmaf(0.5f, tanhf(0.5f * as), 0.5f);
}

// --- producer: one thread of the producer warp ----------------------------

struct Rings {
  uint8_t* win;        // nwin window slots
  uint8_t* wst;        // nwst weight slots
  uint64_t* win_full;
  uint64_t* win_empty;
  uint64_t* w_full;
  uint64_t* w_empty;
};

// The stage's two weight boxes of map m: columns n0 and n1, K rows k0..+64.
__device__ __forceinline__ void put_weights(const Rings& g, Ring& r, int nst,
                                            const CUtensorMap* m, int n0,
                                            int n1, int k0) {
  mbar_wait(&g.w_empty[r.st], r.ph ^ 1);
  uint8_t* s = g.wst + r.st * WSLOT;
  mbar_expect_tx(&g.w_full[r.st], WSLOT);
  tma_load_2d(s, m, n0, k0, &g.w_full[r.st]);
  tma_load_2d(s + WBOX, m, n1, k0, &g.w_full[r.st]);
  r.next(nst);
}

__device__ void feed(const Args& a, const Rings& g) {
  const int per_b = a.T / BM, wbytes = a.win.bytes(), C = a.C;
  Ring rw, rs;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b = tile / per_b, t0 = a.bt + (tile % per_b) * BM;
    for (int c0 = 0; c0 < C; c0 += GW) {
      for (int k0 = 0; k0 < C; k0 += KC) {  // the x window, then its taps
        mbar_wait(&g.win_empty[rw.st], rw.ph ^ 1);
        uint8_t* s = g.win + rw.st * wbytes;
        mbar_expect_tx(&g.win_full[rw.st], wbytes);
        for (int i = 0; i < a.win.nb; ++i)
          tma_load_3d(s + i * a.win.h * 128, &a.map_x, k0,
                      t0 - a.d + i * a.win.h, b, &g.win_full[rw.st]);
        rw.next(a.nwin);
        for (int j = 0; j < 3; ++j)
          put_weights(g, rs, a.nwst, &a.map_win, c0, C + c0, j * C + k0);
      }
      for (int k0 = 0; k0 < a.M; k0 += KC) {  // the conditioning's stages
        mbar_wait(&g.win_empty[rw.st], rw.ph ^ 1);
        uint8_t* s = g.win + rw.st * wbytes;
        mbar_expect_tx(&g.win_full[rw.st], BM * 128);
        tma_load_3d(s, &a.map_spect, k0, t0, b, &g.win_full[rw.st]);
        rw.next(a.nwin);
        put_weights(g, rs, a.nwst, &a.map_wcond, c0, C + c0, k0);
      }
    }
    for (int n0 = 0; n0 < a.rs_out; n0 += NT)  // past rs_out: zero fill
      for (int k0 = 0; k0 < C; k0 += KC)
        put_weights(g, rs, a.nwst, &a.map_wrs, n0, n0 + 64, k0);
  }
}

// --- consumers ---------------------------------------------------------------

// Slots a warpgroup frees once the wgmma group that read them completes.
struct Held {
  int w = -1, win = -1;
};

struct Consumer {
  const Rings& g;
  Ring rw, rs;
  Held held;
  int tid;
  bool eager;  // one window slot: free it as soon as its last group is done

  __device__ __forceinline__ void free_slots(const Held& h) const {
    if (tid != 0) return;
    if (h.w >= 0) mbar_arrive(&g.w_empty[h.w]);
    if (h.win >= 0) mbar_arrive(&g.win_empty[h.win]);
  }
  // A tap group (A in registers) is retired before the next group's
  // ldmatrix: registers that feed a wgmma must not be written while an
  // earlier group is in flight, or ptxas serializes every wgmma of the
  // kernel (its C7513 warning).  Frees the slots held and this group's
  // weight slot (and window, `last_of_window`).
  __device__ __forceinline__ void retired(bool last_of_window) {
    wgmma_wait<0>();
    free_slots(held);
    Held h;
    h.w = rs.st;
    h.win = last_of_window ? rw.st : -1;
    free_slots(h);
    held = Held();
  }
  // After a group with A in shared memory is committed: wait for the one
  // before it, free its slots, hold this one's (the weight slot, and the
  // window when `last_of_window`).
  __device__ __forceinline__ void committed(bool last_of_window) {
    wgmma_wait<1>();
    free_slots(held);
    held.w = rs.st;
    held.win = last_of_window ? rw.st : -1;
    if (eager && last_of_window) {
      wgmma_wait<0>();
      free_slots(held);
      held = Held();
    }
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    free_slots(held);
    held = Held();
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// The in-act product of gate chunk c0 for the block's 64 rows: per x K
// chunk the window's three taps (A by ldmatrix at row offsets 0, d, 2d),
// then the conditioning's stages (A from the window slot's rows).
__device__ __forceinline__ void inact(const Args& a, Consumer& cs,
                                      float (&acc)[64]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // ldmatrix x4: lanes 8i..8i+7 address rows of matrix i (rows 0-7 / 8-15
  // of the warp's 16, K halves 0-7 / 8-15)
  const int arow = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int khalf = lane >> 4;
  const int wbytes = a.win.bytes();
  zero_acc(acc);
  for (int k0 = 0; k0 < a.C; k0 += KC) {
    mbar_wait(&cs.g.win_full[cs.rw.st], cs.rw.ph);
    const uint32_t slot = smem_u32(cs.g.win + cs.rw.st * wbytes);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mbar_wait(&cs.g.w_full[cs.rs.st], cs.rs.ph);
      const uint32_t w = smem_u32(cs.g.wst + cs.rs.st * WSLOT);
      const int row = arow + j * a.d;
      const uint32_t ra = slot + row * 128;
      uint32_t fr[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldsm_x4(fr[ks], ra + (((2 * ks + khalf) ^ (row & 7)) << 4));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_rs_n128(acc, fr[ks], b_stage(w + ks * 2048));
      wgmma_commit();
      cs.retired(j == 2);
      cs.rs.next(a.nwst);
    }
    cs.rw.next(a.nwin);
  }
  for (int k0 = 0; k0 < a.M; k0 += KC) {
    mbar_wait(&cs.g.win_full[cs.rw.st], cs.rw.ph);
    mbar_wait(&cs.g.w_full[cs.rs.st], cs.rs.ph);
    const uint32_t s = smem_u32(cs.g.win + cs.rw.st * wbytes);
    const uint32_t w = smem_u32(cs.g.wst + cs.rs.st * WSLOT);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_ss_n128(acc, a_rows128(s + ks * 32), b_stage(w + ks * 2048));
    wgmma_commit();
    cs.committed(true);
    cs.rs.next(a.nwst);
    cs.rw.next(a.nwin);
  }
  cs.drain();
}

// Gate chunk c0: tile j (tanh columns c0 + 8j + 2q + {0, 1}) with tile
// j + 8 (their sigmoid partners), rows r0 and r0 + 8 -> the gated tile.
__device__ __forceinline__ void gate_chunk(const Args& a, int c0, int r0,
                                           const float (&acc)[64],
                                           uint8_t* G) {
  const int q = threadIdx.x & 3, C = a.C;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + 8 * j + 2 * q;
    const float2 bi_t = *reinterpret_cast<const float2*>(a.b_in + c);
    const float2 bc_t = *reinterpret_cast<const float2*>(a.b_cond + c);
    const float2 bi_s = *reinterpret_cast<const float2*>(a.b_in + C + c);
    const float2 bc_s = *reinterpret_cast<const float2*>(a.b_cond + C + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, k = 4 * (j + 8) + 2 * h;
      const float v0 = gate_value(acc[i] + (bi_t.x + bc_t.x),
                                  acc[k] + (bi_s.x + bc_s.x));
      const float v1 = gate_value(acc[i + 1] + (bi_t.y + bc_t.y),
                                  acc[k + 1] + (bi_s.y + bc_s.y));
      *reinterpret_cast<__nv_bfloat162*>(G + gtile_off(r0 + 8 * h, c)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One res/skip chunk (columns n0..n0+127) for the block's 64 rows: A
// from the gated tile's panels, B from the weight ring.
__device__ __forceinline__ void rs_chunk(const Args& a, Consumer& cs,
                                         const uint8_t* G,
                                         float (&acc)[64]) {
  const uint32_t g0 = smem_u32(G);
  zero_acc(acc);
  for (int k0 = 0; k0 < a.C; k0 += KC) {
    mbar_wait(&cs.g.w_full[cs.rs.st], cs.rs.ph);
    const uint32_t w = smem_u32(cs.g.wst + cs.rs.st * WSLOT);
    const uint32_t p = g0 + (k0 >> 6) * (BM * 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_ss_n128(acc, a_rows128(p + ks * 32), b_stage(w + ks * 2048));
    wgmma_commit();
    cs.committed(false);
    cs.rs.next(a.nwst);
  }
  cs.drain();
}

// STREAM: the residual (zero at real rows >= n_valid) and the skip sum in
// place for rows t[0], t[1] of this thread at columns n0 + 8j + 2q, in two
// groups of 8 column tiles, each group's loads before its stores.
__device__ __forceinline__ void stream_store(const Args& a, int b,
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
            in[jj][h] = *reinterpret_cast<const __nv_bfloat162*>(
                a.x + row[h] + n);
        } else {
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
              __floats2bfloat162_rn(i0 + bf16_round(v0), i1 + bf16_round(v1));
        }
      }
    }
  }
}

// STREAM_FINAL: s = bf16(skip + rs) at columns n0 + 8j + 2q of rows t[0],
// t[1], folded into the rows' E partial sums against w_end (sw: [C, 8]
// bf16 in shared memory, zero past E).
__device__ __forceinline__ void final_fold(const Args& a, int b,
                                           const int (&t)[2], int n0,
                                           const float (&acc)[64],
                                           const bf16* sw,
                                           float (&part)[2][E_PAD]) {
  const int q = threadIdx.x & 3, C = a.C;
#pragma unroll
  for (int jg = 0; jg < 16; jg += 8) {
    __nv_bfloat162 sk[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + 8 * (jg + jj) + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sk[jj][h] = n < C ? *reinterpret_cast<const __nv_bfloat162*>(
                                a.skip + ((size_t)b * a.Tp + t[h]) * C + n)
                          : __floats2bfloat162_rn(0.f, 0.f);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = jg + jj, n = n0 + 8 * j + 2 * q;
      if (n >= C) continue;
      const float2 br = *reinterpret_cast<const float2*>(a.b_rs + n);
      const uint4 w0 = *reinterpret_cast<const uint4*>(sw + (size_t)n * E_PAD);
      const uint4 w1 =
          *reinterpret_cast<const uint4*>(sw + (size_t)(n + 1) * E_PAD);
      const bf16* e0 = reinterpret_cast<const bf16*>(&w0);
      const bf16* e1 = reinterpret_cast<const bf16*>(&w1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = bf16_round(__low2float(sk[jj][h]) +
                                    (acc[4 * j + 2 * h] + br.x));
        const float s1 = bf16_round(__high2float(sk[jj][h]) +
                                    (acc[4 * j + 2 * h + 1] + br.y));
#pragma unroll
        for (int e = 0; e < E_PAD; ++e)
          part[h][e] = fmaf(s1, __bfloat162float(e1[e]),
                            fmaf(s0, __bfloat162float(e0[e]), part[h][e]));
      }
    }
  }
}

template <int ROLE>
__device__ void consume(const Args& a, const Rings& g, uint8_t* G,
                        bf16* sw) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int per_b = a.T / BM;
  Consumer cs{g, Ring(), Ring(), Held(), tid, a.nwin == 1};
  if (ROLE == STREAM_FINAL) {  // w_end -> [C, 8] bf16, zero past E
    for (int i = tid; i < a.C * E_PAD; i += 128) {
      const int c = i / E_PAD, e = i % E_PAD;
      sw[i] = e < a.E ? a.w_end[(size_t)c * a.E + e] : __float2bfloat16(0.f);
    }
    wg_barrier(1, 128);
  }
  float acc[64];
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b = tile / per_b, t0 = a.bt + (tile % per_b) * BM;
    const int t[2] = {t0 + r0, t0 + r0 + 8};
    for (int c0 = 0; c0 < a.C; c0 += GW) {
      inact(a, cs, acc);
      gate_chunk(a, c0, r0, acc, G);
    }
    // the gated rows -> the warpgroup's wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_barrier(2, 128);
    if (ROLE == STREAM) {
      for (int n0 = 0; n0 < a.rs_out; n0 += NT) {
        rs_chunk(a, cs, G, acc);
        stream_store(a, b, t, n0, acc);
      }
      if (a.rs_out == a.C) {  // skip only: the hidden state passes, masked
        const int cv = a.C / 8;
        for (int i = tid; i < 64 * cv; i += 128) {
          const int tt = t0 + i / cv;
          const size_t o = ((size_t)b * a.Tp + tt) * a.C + (i % cv) * 8;
          *reinterpret_cast<uint4*>(a.x_out + o) =
              tt - a.bt < a.n_valid ? *reinterpret_cast<const uint4*>(a.x + o)
                                    : make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      float part[2][E_PAD];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < E_PAD; ++e) part[h][e] = 0.f;
      for (int n0 = 0; n0 < a.C; n0 += NT) {
        rs_chunk(a, cs, G, acc);
        final_fold(a, b, t, n0, acc, sw, part);
      }
      const int q = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < E_PAD; ++e) {
          part[h][e] += __shfl_xor_sync(0xffffffffu, part[h][e], 1);
          part[h][e] += __shfl_xor_sync(0xffffffffu, part[h][e], 2);
        }
        float* o = a.out + ((size_t)b * a.Tp + t[h]) * a.E;
#pragma unroll
        for (int e = 0; e < E_PAD; ++e)
          if (e / 2 == q && e < a.E) o[e] = part[h][e] + a.b_end[e];
      }
    }
  }
  // the pad tiles: zeros, a grid-stride share of them
  const int nthreads = gridDim.x * 128;
  const int first = blockIdx.x * 128 + tid;
  const int pad_rows = a.B * 2 * a.bt;
  if (ROLE == STREAM) {
    const int cv = a.C / 8;
    for (int i = first; i < pad_rows * cv; i += nthreads) {
      const int pr = i / cv, b = pr / (2 * a.bt), r = pr % (2 * a.bt);
      const int tt = r < a.bt ? r : a.Tp - 2 * a.bt + r;
      const size_t o = ((size_t)b * a.Tp + tt) * a.C + (i % cv) * 8;
      *reinterpret_cast<uint4*>(a.x_out + o) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(a.skip + o) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = first; i < pad_rows * a.E; i += nthreads) {
      const int pr = i / a.E, b = pr / (2 * a.bt), r = pr % (2 * a.bt);
      const int tt = r < a.bt ? r : a.Tp - 2 * a.bt + r;
      a.out[((size_t)b * a.Tp + tt) * a.E + i % a.E] = 0.f;
    }
  }
}

template <int ROLE>
__global__ void __launch_bounds__(160, 1)
    wn_padded_sm90_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t win_full[MAX_WIN], win_empty[MAX_WIN];
  __shared__ __align__(8) uint64_t w_full[MAX_WST], w_empty[MAX_WST];
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  uint8_t* G = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Rings g;
  g.win = G + (size_t)BM * a.C * 2;
  g.wst = g.win + (size_t)a.nwin * a.win.bytes();
  g.win_full = win_full;
  g.win_empty = win_empty;
  g.w_full = w_full;
  g.w_empty = w_empty;
  bf16* sw = reinterpret_cast<bf16*>(g.wst + (size_t)a.nwst * WSLOT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nwin; ++s) {
      mbar_init(&win_full[s], 1);
      mbar_init(&win_empty[s], 1);
    }
    for (int s = 0; s < a.nwst; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // the producer warp: one thread loads
    if (threadIdx.x == 128) feed(a, g);
  } else {
    consume<ROLE>(a, g, G, sw);
  }
}

// --- host -------------------------------------------------------------------

int encode_padded_maps(Args& a, const void* x, const void* spect,
                       const void* w_in, const void* w_cond,
                       const void* w_rs) {
  const cuuint64_t B = a.B, Tp = a.Tp, C = a.C, M = a.M;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int e;
  {
    const cuuint64_t dims[3] = {C, Tp, B};
    const cuuint64_t str[2] = {C * 2, Tp * C * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)a.win.h, 1};
    if ((e = encode(&a.map_x, x, 3, dims, str, box, sw))) return e;
  }
  {
    const cuuint64_t dims[3] = {M, Tp, B};
    const cuuint64_t str[2] = {M * 2, Tp * M * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)BM, 1};
    if ((e = encode(&a.map_spect, spect, 3, dims, str, box, sw))) return e;
  }
  const cuuint32_t wbox[2] = {64, 64};
  {
    const cuuint64_t dims[2] = {2 * C, 3 * C};
    const cuuint64_t str[1] = {2 * C * 2};
    if ((e = encode(&a.map_win, w_in, 2, dims, str, wbox, sw))) return e;
  }
  {
    const cuuint64_t dims[2] = {2 * C, M};
    const cuuint64_t str[1] = {2 * C * 2};
    if ((e = encode(&a.map_wcond, w_cond, 2, dims, str, wbox, sw))) return e;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.rs_out, C};
  const cuuint64_t str[1] = {(cuuint64_t)a.rs_out * 2};
  return encode(&a.map_wrs, w_rs, 2, dims, str, wbox, sw);
}

template <int ROLE>
int start(const Args& a, void* stream) {
  const size_t smem = padded_smem(ROLE, a.C, a.d, a.nwin, a.nwst);
  cudaError_t e = cudaFuncSetAttribute(
      wn_padded_sm90_kernel<ROLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.tiles < sms ? a.tiles : sms;
  wn_padded_sm90_kernel<ROLE><<<grid, 160, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Fills the shapes and the plan; returns false on what the kernel refuses.
bool fill(Args& a, int B, int Tp, int bt, int n_valid, int C, int M,
          int rs_out, int E, int d, int nwin, int nwst) {
  memset(&a, 0, sizeof(a));
  a.B = B; a.Tp = Tp; a.bt = bt; a.T = Tp - 2 * bt; a.n_valid = n_valid;
  a.C = C; a.M = M; a.rs_out = rs_out; a.E = E; a.d = d;
  a.nwin = nwin; a.nwst = nwst;
  a.win = window_of(d);
  a.tiles = B * (a.T / BM);
  return B >= 1 && bt % 64 == 0 && a.T > 0 && a.T % BM == 0 && C > 0 &&
         C % 64 == 0 && M > 0 && M % 32 == 0 && d >= 0 && d <= bt &&
         n_valid >= 0 && n_valid <= a.T && (rs_out == C || rs_out == 2 * C) &&
         nwin >= 1 && nwin <= MAX_WIN &&
         nwst >= 2 && nwst <= MAX_WST;
}

}  // namespace

// Plain C interface (loaded with ctypes).  bf16 activations and weights,
// f32 biases, all dense and 16-byte aligned: x, spect, skip [B, Tp, .],
// w_in [3, C, 2C], w_cond [M, 2C], w_rs [C, rs_out], w_end [C, E].  `nwin`
// and `nwst` (ring depths) are the plan of ops/wn_block_padded.py; shapes
// are checked there first.
// Each returns 0, a cudaError_t after the launch, or minus the CUresult of
// a refused tensor map.
extern "C" {

// `role`: 0 STREAM, 1 STREAM_FINAL
size_t t2s_wn_padded_sm90_smem_bytes(int role, int C, int d, int nwin,
                                     int nwst) {
  return padded_smem(role, C, d, nwin, nwst);
}

int t2s_wn_stream_sm90(const void* x, const void* spect, const void* w_in,
                       const void* b_in, const void* w_cond,
                       const void* b_cond, const void* w_rs, const void* b_rs,
                       void* skip, void* x_out, int B, int Tp, int bt,
                       int n_valid, int C, int M, int rs_out, int d,
                       int nwin, int nwst, void* stream) {
  Args a;
  if (!fill(a, B, Tp, bt, n_valid, C, M, rs_out, 1, d, nwin, nwst))
    return (int)cudaErrorInvalidValue;
  a.x = (const bf16*)x;
  a.b_in = (const float*)b_in;
  a.b_cond = (const float*)b_cond;
  a.b_rs = (const float*)b_rs;
  a.skip = (bf16*)skip;
  a.x_out = (bf16*)x_out;
  const int e = encode_padded_maps(a, x, spect, w_in, w_cond, w_rs);
  if (e) return e;
  return start<STREAM>(a, stream);
}

int t2s_wn_stream_final_sm90(const void* x, const void* spect,
                             const void* w_in, const void* b_in,
                             const void* w_cond, const void* b_cond,
                             const void* w_rs, const void* b_rs,
                             const void* skip_acc, const void* w_end,
                             const void* b_end, void* out, int B, int Tp,
                             int bt, int C, int M, int E, int d, int nwin,
                             int nwst, void* stream) {
  Args a;
  if (!fill(a, B, Tp, bt, Tp - 2 * bt, C, M, C, E, d, nwin, nwst) ||
      E < 1 || E > E_PAD)
    return (int)cudaErrorInvalidValue;
  a.x = (const bf16*)x;
  a.b_in = (const float*)b_in;
  a.b_cond = (const float*)b_cond;
  a.b_rs = (const float*)b_rs;
  a.skip = (bf16*)skip_acc;
  a.w_end = (const bf16*)w_end;
  a.b_end = (const float*)b_end;
  a.out = (float*)out;
  const int e = encode_padded_maps(a, x, spect, w_in, w_cond, w_rs);
  if (e) return e;
  return start<STREAM_FINAL>(a, stream);
}

}  // extern "C"
