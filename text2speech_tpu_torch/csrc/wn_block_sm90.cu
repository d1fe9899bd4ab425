// WaveGlow WN coupling layer, standard and final roles, redesigned for
// Hopper (sm_90a): wgmma, TMA and 128-row tiles.
//
//   STD    replaces text2speech_tpu/ops/pallas/wn_block.py:398
//          wn_layer_stream2 (body _kernel_stream2, :200)
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block.py:528
//          wn_layer_stream2_final (body _kernel_stream2_final, :325)
//   STD, DCOND  replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:43
//          wn_layer_stream2_dcond (pallas_call :73; body _kernel_stream2
//          with project_cond=False)
//   FINAL, DCOND  replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:162
//          wn_layer_stream2_final_dcond (pallas_call :203; body
//          wn_block.py:325 _kernel_stream2_final with project_cond=False,
//          fold_rs=True)
//   PART   replaces text2speech_tpu/ops/pallas/wn_block.py:642
//          wn_layer_stream2_partial (body _kernel_stream2_partial, :612),
//          layers 1..L-1 of the tensor-parallel vocoder
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block.py:459
//          wn_layer_stream2_first (pallas_call :497; body
//          _kernel_stream2_first, :281, project_cond=True)
//   FIRST, DCOND  replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:100
//          wn_layer_stream2_first_dcond (pallas_call :133; the same body
//          with project_cond=False, reading slice 0 of cond_all)
//   PART_FIRST  replaces text2speech_tpu/ops/pallas/wn_block.py:642
//          wn_layer_stream2_partial with b_edge (pallas_call :683; body
//          _kernel_stream2_partial, :612, edge_bias=True), layer 0 of the
//          tensor-parallel vocoder
//
// The function is that of wn_block.cu's STD and FINAL roles, for rows t of
// one utterance (hidden x [T, C], grouped mel spect [T, M], dilation d,
// valid length n_valid):
//
//   in_act[t] = x[t-d] W0 + x[t] W1 + x[t+d] W2 + spect[t] Wc + b   [2C], f32
//   acts[t]   = bf16( tanh(in_act[t, :C]) * sigmoid(in_act[t, C:]) )
//   STD:   rs[t] = acts[t] W_rs + b_rs                                f32
//          x_out[t] = t < n_valid ? bf16(x[t] + rs[t, :C]) : 0
//          skip[t]  = bf16(skip_acc[t] + bf16(rs[t, C:]))   (in place)
//          (rs_out == C: skip only, x passes through)
//   FINAL: out[t] = acts[t] W_rs' + skip_acc[t] W_end + b'   [E <= 8], f32
//
// with x rows outside [0, n_valid) read as zero.  With DCOND (the
// composed-conditioning vocoder) the standard and final layers have no
// spect rows:
//
//   in_act[t] = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b_in
//               + f32(cond_all[t, off : off + 2C])                 (t < T)
//
// with cond_all [B, T, cond_ld] bf16 (the folded conditioning bias already
// in it) read in place at column offset off = 2C * layer.  PART is one
// rank's share of a layer under tensor parallelism: the hidden state's
// width CX (the taps' K) and the rank's gate width Cp (its gate-paired
// columns of w_in [3, CX, 2Cp] and w_cond [M, 2Cp], the res/skip K) are
// two widths, and the kernel's C below is Cp:
//
//   PART:  part[t] = t < n_valid ? acts[t] W_rs : 0   [rs_out], f32
//
// with W_rs the rank's rows [Cp, rs_out]: no bias, residual or skip sum
// (they need the sum over ranks).  wn_block.cu keeps the first design of
// these roles (64-row blocks, mma.sync, cp.async); its entry points
// t2s_wn_layer, t2s_wn_layer_final, t2s_wn_layer_dcond,
// t2s_wn_layer_final_dcond, t2s_wn_layer_first, t2s_wn_layer_first_dcond
// and t2s_wn_layer_partial (with and without b_edge) stay exported so that
// the two designs can be timed side by side, and nothing else calls them.
//
// What bounds the layer on an H100.  At B=3, T=6400, C=512, M=640 the
// standard layer is 106 GFLOP of bf16 products against ~60 MB of
// activations and 5.3 MB of weights: 0.107 ms at the 989 TFLOP/s peak,
// bound by operations.  The first design reached ~12% of that: mma.sync
// (wgmma is the only route to the peak), a 64-row block that streams the
// layer's 5.3 MB of weights from L2 once per 64 rows, the block's whole
// K = 3C + M operand gathered again for each of C/64 gate-pair chunks, and
// a cp.async pipeline in which every thread issues loads.
//
// Design.  A block owns BM = 128 rows of one utterance, or 64 where 128-row
// blocks would not fill the card once (one utterance) or their gated tile
// would not fit (C > 512); the host plan (ops/wn_block.py sm90_plan)
// chooses.  A block is warp-specialised: NWG = BM / 64 consumer
// warpgroups and one producer warpgroup.
//
// * Loads are TMA, issued by one thread of the producer into a ring of 2-4
//   slots guarded by full/empty mbarriers.  A slot holds a [BK, 256] weight
//   tile (four 64-column boxes, 128-byte swizzle) and a [BM, BK] activation
//   tile, BK = 64 (128-byte swizzle) where three such slots fit beside the
//   gated tile, else 32 (64-byte swizzle).  The three taps are three boxes
//   of x at row coordinates t0-d, t0, t0+d from a tensor map whose T extent
//   is n_valid: TMA's out-of-bounds zero fill is the conv's zero padding at
//   the true length, negative coordinates included, so no halo is gathered
//   by hand.  The spect rows come from a map of extent T.
// * Products are wgmma.mma_async m64n256k16 (bf16 -> f32), A and B from
//   shared memory.  w_in, w_cond and w_rs are stored [K, N] with N
//   contiguous: wgmma's MN-major B, read straight from the TMA tiles.
// * The in-act product runs in gate-pair chunks of 128 tanh + the matching
//   128 sigmoid columns (N = 256): each consumer thread then holds a column
//   and its gate partner in its own accumulator registers (tile j and
//   j + 16), gates in f32 and stores bf16 into the gated tile [BM, C] in
//   shared memory, laid out as 64-column panels with the 128-byte swizzle
//   that the res/skip wgmma reads as its K-major A operand.  The K = 3C + M
//   operand is loaded C/128 times per block (4 at C = 512).
// * STD's res/skip product [BM, C] x [C, rs_out] runs in N = 256 chunks
//   with the residual (masked past n_valid) and the in-place skip sum fused
//   in its epilogue: each block reads and writes its own rows only.
//   FINAL's rank-E end projection is FMAs over the gated tile.
// * Registers: with two consumer warpgroups the block is 384 threads, 168
//   registers each at launch; setmaxnreg gives the consumers 216 and the
//   producer 72.
//
// At BM = 128 the per-row weight stream from L2 halves against the first
// design, and a stage is 87 FLOP of wgmma per byte loaded.  What remains:
// every block still streams all of the weight tiles from L2 and loads its
// activation operand four times, a ring of at most 96 KB beside the 128 KB
// gated tile, and the gate epilogue, during which both warpgroups leave the
// tensor cores idle.  A cluster pair that multicasts the weight tiles, each
// CTA's producer waiting for both CTAs' consumers to free a slot, ran
// slower in the DCOND form (PERF.md): the per-stage handshake across the
// pair costs more than the halved L2 reads save.  A pair that splits the
// gate columns is untried.  Measured times are in PERF.md.
//
// DCOND.  The in-act K loop runs over the three tap boxes only: K = 3C,
// 24 stages of 64 at C = 512, no spect map and no w_cond map.  At B=1,
// T=6400 the layer is 26.8 GFLOP against ~40 MB (x, its 2C-wide slice of
// cond_all, the skip sum in and out, weights): 0.0271 ms at the bf16 peak,
// bound by operations.  The conditioning takes b_cond's place in the gate:
// each consumer thread reads its bf16 pairs of a chunk (columns c, c+1 and
// C+c, C+c+1 of its two rows, 16 column tiles) and adds them in f32 after
// b_in; it prefetches their lines into L2 when the chunk's K loop starts,
// so the gate finds them there.  Holding them in registers instead (64 a
// thread, loaded during the last stage's wgmma) spills at 128-row tiles,
// where ptxas gives a thread 168 registers, and ran slower (PERF.md).  A
// TMA tile of the slice ([BM, 256] bf16, 64 KB at BM = 128) would not fit
// beside the 128 KB gated tile and the ring.  n_valid == 0 leaves no K stage at all:
// the producer issues no in-act load, the consumers gate b_in + cond alone,
// and the res/skip ring runs as in STD.  The final layer composes the two
// unchanged: DCOND's gate (the cond_all pairs after b_in, prefetched into
// L2 at each chunk's start) writes the gated tile, and FINAL's epilogue
// reads it and reads skip_acc, which it never writes; at n_valid == 0 the
// producer issues no load at all.  At B=1, T=6400 it is 20.2 GFLOP against
// ~29 MB: 0.0205 ms at the bf16 peak, bound by operations.
//
// PART.  A rank's Cp columns run in the standard layer's gate-pair chunks
// (128 + 128); at Cp % 128 == 64 the last chunk is half: its weight boxes
// past the rank's columns are zero-filled or belong to the sigmoid half,
// and only its 64 tanh columns (tiles 0-7, with partners 16-23) are gated,
// so every Cp % 64 == 0 runs.  The res/skip product's K is Cp; its
// epilogue writes the f32 partial whole, 16 bytes a thread: the two
// threads of a quad pair swap a row's pair of columns by a shuffle, so each
// stores four consecutive floats of one row.  At p = 4, B=1, T=6400 the
// call is 8.8 GFLOP against ~42 MB, 26 MB of it the f32 output: 0.0126 ms
// at 3.35 TB/s, bound by bytes.  The tile is sm90_plan's for width Cp.
//
// FIRST.  Layer 0 of a flow, with the start projection composed onto its
// taps (ops/wn_block.py fold_first_taps, once per checkpoint), on the audio
// half x0 [T, n_half <= 4] bf16, rows outside [0, n_valid) read as zero:
//
//   in_act[t] = sum_j x0[t+(j-1)d] wp[j] + b_all + cond[t]          (f32)
//               - b_edge[0] where t < d, - b_edge[1] where t >= n_valid - d
//   cond[t]   = spect[t] W_cond + b_cond, or with DCOND f32(cond_all[t, 0:2C])
//   x_out[t]  = t < n_valid ? bf16(x0[t] start_k + start_b + rs[t, :C]) : 0
//   skip[t]   = bf16(rs[t, C:])                    (written; no running sum)
//
// with acts and rs as in STD.  The in-act product is the conditioning
// (K = M: ten stages of 64 at M = 640, spect and w_cond boxes, no tap
// boxes; with DCOND none) and, before it, the rank-n_half taps as one more
// stage of a single K = 16 product on the tensor cores: its A tile holds
// x0's three tap rows of each block row, x0[t + (j - 1) d, i] at column
// j n_half + i (zero outside [0, n_valid), past T and past 3 n_half),
// staged once per block by the consumers in the ring's A layout after the
// gated tile; its B tile is the chunk's columns of wp as rows [3 n_half,
// 2C], loaded by TMA with the rows past 3 n_half zero-filled.  The gate is
// STD's (b_all in b_in's place; with DCOND the cond_all pairs after it),
// then the edge take-back.  With DCOND the tap stage is the whole in-act
// product.  The res/skip product is STD's; its epilogue adds the residual
// base x0[t] start_k + start_b (n_half FMAs, masked past n_valid) and
// stores the skip without reading it.  Taps as f32 FMAs in the gate (as
// the int8 kernel computes them) ran slower than the first design at
// batch 3 on an H100 (PERF.md): with one block of 384 threads an SM, the
// gate's loads of wp and the FMA chains leave the tensor cores idle.  At
// B=3, T=6400, C=512, M=640 the layer is 45 GFLOP (the conditioning's and
// the res/skip products) against ~66 MB: 0.046 ms at the bf16 peak, bound
// by operations; with DCOND 20 GFLOP against ~79 MB (x0, the 2C-wide slice
// of cond_all, the two outputs): 0.024 ms, bound by bytes.
//
// PART_FIRST.  Layer 0 of a flow under tensor parallelism: FIRST's in-act
// product on the rank's gate-paired columns (wp [3, n_half, 2Cp], b_all,
// b_edge [2, 2Cp] from fold_first_taps of the rank's w_in and b_in, w_cond
// [M, 2Cp], b_cond), then PART's res/skip product and epilogue:
//
//   in_act[t] = sum_j x0[t+(j-1)d] wp[j] + b_all + spect[t] W_cond + b_cond
//               - b_edge[0] where t < d, - b_edge[1] where t >= n_valid - d
//   part[t]   = t < n_valid ? acts[t] W_rs : 0           [rs_out], f32
//
// with no residual base, bias or skip: they follow the sum over ranks.  So
// it is FIRST's tap stage (x0's tap tile staged once, wp's 16 rows of the
// chunk by TMA), the conditioning's K = M stages, PART's gate (a half chunk
// at Cp % 128 == 64: wp and w_cond boxes past the rank's columns belong to
// the sigmoid half or are zero-filled) with FIRST's edge take-back, and
// part_store.  At B=3, T=6400, M=640, Cp = 256 (p = 2), rs_out = 2C =
// 1024 the call is 23 GFLOP against ~104 MB (spect 24.6 MB, the f32
// partial 78.6 MB): 0.031 ms at 3.35 TB/s, bound by bytes.
//
// A wait on an mbarrier that does not complete within seconds traps (a
// launch error) instead of hanging the card.

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int GN = 256;                 // gate-pair chunk: 128 + 128 columns
constexpr int GHALF = GN / 2;
constexpr int MAX_STAGES = 4;
constexpr int MAX_E = 8;
constexpr int EG = 4;  // column tiles per res/skip epilogue group
constexpr int MAX_NHALF = 4;  // FIRST: audio half channels
constexpr int TAP_ROWS = 16;  // FIRST: K of the tap stage (3 n_half <= 12)

// The block's shape: NWG consumer warpgroups of 64 rows, K = BK per ring
// stage (32 or 64).  A slot holds four [BK, 64] weight boxes and the
// [BM, BK] activation tile, whose rows are BK bf16: 64 bytes (64-byte
// swizzle) or 128 bytes (128-byte swizzle).
template <int NWG, int BK>
struct Tile {
  static constexpr int BM = NWG * 64;
  static constexpr int B_BOX = BK * 64 * 2;
  static constexpr int B_STAGE = 4 * B_BOX;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = B_STAGE + A_BYTES;
  static constexpr uint64_t A_LAYOUT = BK == 64 ? 1 : 2;
  static constexpr uint32_t A_SBO = 8 * BK * 2;
};

enum Role { STD = 0, FINAL = 1, PART = 2, FIRST = 3, PART_FIRST = 4 };

// FIRST and PART_FIRST: the rank-n_half composed taps as one K = 16 stage
__host__ __device__ constexpr bool tap_stage_role(int role) {
  return role == FIRST || role == PART_FIRST;
}

struct Params {
  CUtensorMap tm_x;      // x as [B, n_valid, CX]; box {BK, BM, 1}
  CUtensorMap tm_spect;  // spect [B, T, M]; box {BK, BM, 1}
  CUtensorMap tm_win;    // w_in as [3CX, 2C]; box {64, BK}, 128B swizzle
  CUtensorMap tm_wcond;  // w_cond [M, 2C]; box {64, BK}, 128B swizzle
  CUtensorMap tm_wrs;    // STD, PART, FIRST: w_rs [C, rs_out]; box {64, BK}
  CUtensorMap tm_wp;     // FIRST, PART_FIRST: wp as [3 n_half, 2C]; box
                         // {64, 16}
  int T, n_valid, C, M, d, rs_out, E;
  int CX;                // the hidden state's width: C except in PART
  int ktap;              // 3CX, or 0 when n_valid == 0 (every tap reads 0)
                         // and in FIRST, PART_FIRST (one tap stage)
  int stages;
  const bf16* x;         // [B, T, C]
  const bf16* cond_all;  // DCOND: [B, T, cond_ld]; the layer reads columns
  int cond_ld, cond_off; //   [cond_off, cond_off + 2C) in place
  const float* b_in;     // [2C] (FIRST: b_all, b_in + the folded tap bias)
  const float* b_cond;   // [2C]
  const float* b_rs;     // STD, FIRST: [rs_out]
  bf16* skip;            // [B, T, C] running skip sum (STD: updated in place;
                         // FINAL: read; FIRST: written)
  bf16* x_out;           // STD, FIRST: [B, T, C]
  const bf16* w_eff;     // FINAL: w_rs @ w_end [C, E]
  const bf16* w_end;     // FINAL: [C, E]
  const float* b_eff;    // FINAL: [E]
  float* out;            // FINAL: [B, T, E]; PART, PART_FIRST: [B, T,
                         // rs_out]
  int n_half;            // FIRST, PART_FIRST: audio half channels
  const bf16* x0;        // FIRST, PART_FIRST: [B, T, n_half]
  const float* b_edge;   // FIRST, PART_FIRST: [2, 2C] (left, right)
  const bf16* start_k;   // FIRST: [n_half, C]
  const float* start_b;  // FIRST: [C]
};


// A from a ring slot: K-major, rows of BK bf16 swizzled across the row,
// 8-row groups 8 rows apart.
template <int NWG, int BK>
__device__ __forceinline__ uint64_t desc_a_ring(uint32_t addr) {
  return make_desc(addr, 16, Tile<NWG, BK>::A_SBO, Tile<NWG, BK>::A_LAYOUT);
}
// A from the gated tile: K-major, rows of 64 bf16 (128 bytes), 128-byte
// swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_a_gated(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}
// B from a ring slot: MN-major, 128-byte swizzle; 64-column boxes B_BOX
// apart (leading), 8-row K groups 1024 bytes apart (stride).
template <int BK>
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return make_desc(addr, BK * 128, 1024, 1);
}

// tanh(at) * sigmoid(as) in f32; the sigmoid by the fast exp and
// reciprocal (a few ulp, far below the bf16 step the result is rounded to)
__device__ __forceinline__ float gate_f32(float at, float as) {
  return tanhf(at) * __frcp_rn(1.f + __expf(-as));
}

// Byte offset of (row r, column c) in the gated tile: 64-column panels of
// BM rows x 128 bytes, 16-byte chunks swizzled by the row (the layout TMA's
// 128-byte swizzle gives, and wgmma's K-major A expects).
template <int BM>
__device__ __forceinline__ uint32_t gated_off(int r, int c) {
  return (uint32_t)((c >> 6) * (BM * 128) + r * 128 +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// --- producer ---------------------------------------------------------------

template <int ROLE, int NWG, int BK>
__device__ __forceinline__ void produce(const Params& p, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int b, int t0) {
  using TL = Tile<NWG, BK>;
  constexpr int A_BYTES = TL::A_BYTES, STAGE = TL::STAGE;
  constexpr int B_BOX = TL::B_BOX, B_STAGE = TL::B_STAGE;
  const int C = p.C;
  const int nk = (p.ktap + p.M + BK - 1) / BK;  // M % BK: zero fill
  Ring r;
  for (int c0 = 0; c0 < C; c0 += GHALF) {
    if (tap_stage_role(ROLE)) {  // the tap stage: the chunk's 16 rows of wp
      mbar_wait(&empty[r.st], r.ph ^ 1);
      uint8_t* slot = ring + r.st * STAGE;
      uint64_t* bar = &full[r.st];
      mbar_expect_tx(bar, 4 * TAP_ROWS * 64 * 2);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load_2d(slot + q * B_BOX, &p.tm_wp,
                    (q < 2 ? c0 : C + c0) + (q & 1) * 64, 0, bar);
      r.next(p.stages);
    }
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&empty[r.st], r.ph ^ 1);
      uint8_t* slot = ring + r.st * STAGE;
      uint64_t* bar = &full[r.st];
      mbar_expect_tx(bar, B_STAGE + A_BYTES);
      const int k0 = ks * BK;
      const bool tap = k0 < p.ktap;
      const CUtensorMap* wm = tap ? &p.tm_win : &p.tm_wcond;
      const int kr = tap ? k0 : k0 - p.ktap;
      if (tap) {
        const int j = k0 / p.CX;
        tma_load_3d(slot + B_STAGE, &p.tm_x, k0 - j * p.CX, t0 + (j - 1) * p.d,
                    b, bar);
      } else {
        tma_load_3d(slot + B_STAGE, &p.tm_spect, kr, t0, b, bar);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = (q < 2 ? c0 : C + c0) + (q & 1) * 64;
        tma_load_2d(slot + q * B_BOX, wm, col, kr, bar);
      }
      r.next(p.stages);
    }
  }
  if (ROLE != FINAL) {
    // a last half chunk (rs_out an odd multiple of 128) reads zeros past
    // rs_out: TMA fills them, and counts a whole box either way
    for (int n0 = 0; n0 < p.rs_out; n0 += GN) {
      for (int ks = 0; ks < C / BK; ++ks) {
        mbar_wait(&empty[r.st], r.ph ^ 1);
        uint8_t* slot = ring + r.st * STAGE;
        uint64_t* bar = &full[r.st];
        mbar_expect_tx(bar, B_STAGE);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load_2d(slot + q * B_BOX, &p.tm_wrs, n0 + q * 64, ks * BK, bar);
        r.next(p.stages);
      }
    }
  }
}

// --- consumers --------------------------------------------------------------

__device__ __forceinline__ void zero(float* acc) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
}

// DCOND: bring this thread's conditioning of one gate-pair chunk into L2
// ahead of the gate: its rows r0 and r0 + 8 (t < T) read 128 tanh and 128
// sigmoid columns, four 128-byte lines a row, and the four threads of a
// quad that share the rows prefetch one line each.  Prefetches hold no
// register, so the chunk's K loop hides their latency.
__device__ __forceinline__ void prefetch_cond(const Params& p, int wg,
                                              int tid, int b, int t0,
                                              int c0) {
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
    if (t >= p.T) continue;
    const bf16* line = p.cond_all + ((size_t)b * p.T + t) * p.cond_ld +
                       p.cond_off + c0 + (q >> 1) * p.C + (q & 1) * 64;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
  }
}

// Byte offset of (row r, k) in a ring A tile [BM, BK] bf16: rows of BK
// values, 16-byte chunks swizzled by the row as TMA's 128-byte (BK = 64)
// or 64-byte (BK = 32) swizzle lays them out.
template <int BK>
__device__ __forceinline__ uint32_t a_off(int r, int k) {
  return BK == 64 ? (uint32_t)(r * 128 + (((k >> 3) ^ (r & 7)) << 4) +
                               ((k & 7) << 1))
                  : (uint32_t)(r * 64 + (((k >> 3) ^ ((r >> 1) & 3)) << 4) +
                               ((k & 7) << 1));
}

// FIRST, PART_FIRST: this warpgroup's 64 rows of the tap stage's A tile xa
// [BM, BK] (the ring's A layout): x0[t + (j - 1) d, i] at column j n_half +
// i, zero outside [0, n_valid), past T and from column 3 n_half on.
template <int BK>
__device__ __forceinline__ void stage_taps(const Params& p, int wg, int tid,
                                           int b, int t0, uint8_t* xa) {
  const int nh = p.n_half;
  for (int i = tid; i < 64 * BK; i += 128) {
    const int r = wg * 64 + i / BK, k = i % BK;
    const int j = k / nh, c = k - j * nh;
    const int t = t0 + r, s = t + (j - 1) * p.d;
    *reinterpret_cast<bf16*>(xa + a_off<BK>(r, k)) =
        j < 3 && t < p.T && s >= 0 && s < p.n_valid
            ? p.x0[((size_t)b * p.T + s) * nh + c]
            : __float2bfloat16(0.f);
  }
}

// The in-act product of one gate-pair chunk for this warpgroup's 64 rows.
// DCOND: the chunk's conditioning is prefetched into L2 first.  FIRST,
// PART_FIRST: the tap stage comes first, one K = 16 product of the block's
// tap tile xa and the slot's wp rows.
template <int ROLE, int NWG, int BK, bool DCOND>
__device__ __forceinline__ void inact_chunk(const Params& p, uint8_t* ring,
                                            uint64_t* full, uint64_t* empty,
                                            Ring& r, int wg, int tid,
                                            float* acc, int b, int t0,
                                            int c0, const uint8_t* xa) {
  using TL = Tile<NWG, BK>;
  // M % BK: zero fill
  const int nk = tap_stage_role(ROLE) + (p.ktap + p.M + BK - 1) / BK;
  if (DCOND) prefetch_cond(p, wg, tid, b, t0, c0);
  zero(acc);
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks) {
    mbar_wait(&full[r.st], r.ph);
    const uint32_t s = smem_u32(ring + r.st * TL::STAGE);
    const uint32_t a = s + TL::B_STAGE + wg * 64 * BK * 2;
    wgmma_fence();
    if (tap_stage_role(ROLE) && ks == 0) {
      wgmma_n256<0, 1>(acc,
                       desc_a_ring<NWG, BK>(smem_u32(xa) + wg * 64 * BK * 2),
                       desc_b<BK>(s), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<0, 1>(acc, desc_a_ring<NWG, BK>(a + kk * 32),
                         desc_b<BK>(s + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    prev = r.st;
    r.next(p.stages);
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
}

// Gate one chunk in f32 and store it as bf16 into the gated tile: 128
// columns, or the 64 of a half chunk (PART at Cp % 128 == 64).  The
// bias is b_in + b_cond, or with DCOND b_in and then the row's
// conditioning: the bf16 pairs (c, c + 1) and (C + c, C + c + 1) of
// cond_all's slice for rows t < T (the order of the plain version's sums;
// rows at or past n_valid are gated, and reach the skip sum, like any
// other, as in the first design).  FIRST, PART_FIRST: b_in is b_all, and
// after the conditioning the folded start bias is taken back where the
// left (t < d) or the right (t >= n_valid - d) tap reads past an edge
// (b_edge [2, 2C]).
template <int ROLE, int BM, bool DCOND>
__device__ __forceinline__ void gate_store(const Params& p, int b, int t0,
                                           int c0, int wg, int tid,
                                           const float* acc, uint8_t* G) {
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
  const int C = p.C;
  const __nv_bfloat162* crow[2];
  bool left[2], right[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
    crow[h] = !DCOND || t >= p.T ? nullptr
        : reinterpret_cast<const __nv_bfloat162*>(
              p.cond_all + ((size_t)b * p.T + t) * p.cond_ld + p.cond_off +
              c0 + 2 * q);
    left[h] = tap_stage_role(ROLE) && t < p.d;
    right[h] = tap_stage_role(ROLE) && t >= p.n_valid - p.d;
  }
  const int ntile = C - c0 < GHALF ? 8 : 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j >= ntile) break;
    const int c = c0 + 8 * j + 2 * q;
    float bt0 = p.b_in[c], bt1 = p.b_in[c + 1];
    float bs0 = p.b_in[C + c], bs1 = p.b_in[C + c + 1];
    if (!DCOND) {
      bt0 += p.b_cond[c];
      bt1 += p.b_cond[c + 1];
      bs0 += p.b_cond[C + c];
      bs1 += p.b_cond[C + c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, k = 4 * (j + 16) + 2 * h;
      float at0 = acc[i] + bt0, at1 = acc[i + 1] + bt1;
      float as0 = acc[k] + bs0, as1 = acc[k + 1] + bs1;
      if (DCOND && crow[h]) {
        const __nv_bfloat162 ct = __ldg(crow[h] + 4 * j);
        const __nv_bfloat162 cs = __ldg(crow[h] + C / 2 + 4 * j);
        at0 += __low2float(ct);
        at1 += __high2float(ct);
        as0 += __low2float(cs);
        as1 += __high2float(cs);
      }
      if (left[h]) {
        at0 -= p.b_edge[c];
        at1 -= p.b_edge[c + 1];
        as0 -= p.b_edge[C + c];
        as1 -= p.b_edge[C + c + 1];
      }
      if (right[h]) {
        at0 -= p.b_edge[2 * C + c];
        at1 -= p.b_edge[2 * C + c + 1];
        as0 -= p.b_edge[3 * C + c];
        as1 -= p.b_edge[3 * C + c + 1];
      }
      __nv_bfloat162 v;
      v.x = __float2bfloat16(gate_f32(at0, as0));
      v.y = __float2bfloat16(gate_f32(at1, as1));
      *reinterpret_cast<__nv_bfloat162*>(G + gated_off<BM>(r0 + 8 * h, c)) = v;
    }
  }
}

// --- FIRST ------------------------------------------------------------------

__device__ __forceinline__ float bf16_half(unsigned pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

// FIRST: the residual base x0[t] start_k + start_b of rows r0 and r0 + 8
// (xc: their x0 rows as bf16 pairs, zero past n_half) at columns n, n + 1:
// n_half FMAs, every load issued (rows of start_k past n_half repeat the
// last against an x0 of 0), then the bias (the plain version's order).
__device__ __forceinline__ void first_base(const Params& p,
                                           const uint2 (&xc)[2], int n,
                                           float2 (&base)[2]) {
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < MAX_NHALF; ++i) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
        p.start_k + (size_t)min(i, p.n_half - 1) * p.C + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = bf16_half(i < 2 ? xc[h].x : xc[h].y, i & 1);
      s[h][0] = fmaf(x, bf16_half(w, 0), s[h][0]);
      s[h][1] = fmaf(x, bf16_half(w, 1), s[h][1]);
    }
  }
  const float2 sb = __ldg(reinterpret_cast<const float2*>(p.start_b + n));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    base[h] = make_float2(s[h][0] + sb.x, s[h][1] + sb.y);
}

// PART's and PART_FIRST's epilogue of one res/skip chunk: the f32 partial,
// zero at rows t >= n_valid.  Lanes q and q ^ 1 of a quad swap half of
// their pairs, so that an even lane holds four columns of row r0 and an odd
// lane four of row r0 + 8; each stores them as one 16-byte vector.
__device__ __forceinline__ void part_store(const Params& p, int b, int t0,
                                           int r0, int q, int n0, int nn,
                                           const float* acc) {
  const bool odd = q & 1;
  const int t = t0 + r0 + (odd ? 8 : 0);
  const bool ok = t < p.n_valid;
  float* row = p.out + ((size_t)b * p.T + t) * p.rs_out;
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    if (8 * j >= nn) break;
    // send the pair the partner keeps: an even lane its row r0 + 8 pair,
    // an odd lane its row r0 pair (static indices only: a runtime index
    // would move the accumulators, which wgmma writes asynchronously, to
    // local memory)
    const float a0 = acc[4 * j], a1 = acc[4 * j + 1];
    const float a2 = acc[4 * j + 2], a3 = acc[4 * j + 3];
    const float g0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
    const float g1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
    float4 v = odd ? make_float4(g0, g1, a2, a3) : make_float4(a0, a1, g0, g1);
    if (!ok) v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < p.T)
      *reinterpret_cast<float4*>(row + n0 + 8 * j + 2 * (q & 2)) = v;
  }
}

// STD, PART, FIRST, PART_FIRST: the res/skip product in chunks of N = 256,
// A from the gated tile, with STD's residual and skip epilogue, the f32
// partial (PART, PART_FIRST) or FIRST's (the residual base from x0, the
// skip written, not summed).
template <int ROLE, int NWG, int BK>
__device__ __forceinline__ void rs_phase(const Params& p, uint8_t* ring,
                                         uint64_t* full, uint64_t* empty,
                                         Ring& r, int wg, int tid, int b,
                                         int t0, const uint8_t* G) {
  constexpr int BM = NWG * 64;
  constexpr int STAGE = Tile<NWG, BK>::STAGE;
  // FIRST's residual bases take twice the registers of STD's bf16 inputs
  constexpr int NG = ROLE == FIRST ? EG / 2 : EG;
  const int C = p.C, T = p.T;
  const bool has_res = p.rs_out == 2 * C;
  const uint32_t g = smem_u32(G) + wg * 64 * 128;
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
  // FIRST: x0[t] of rows r0, r0 + 8 as bf16 pairs, zero past n_half and
  // at rows t >= n_valid (whose residual is masked)
  uint2 xc[2] = {make_uint2(0, 0), make_uint2(0, 0)};
  if (ROLE == FIRST) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
      unsigned short v[MAX_NHALF] = {0, 0, 0, 0};
      if (t < p.n_valid)
#pragma unroll
        for (int i = 0; i < MAX_NHALF; ++i)
          if (i < p.n_half)
            v[i] = reinterpret_cast<const unsigned short*>(
                p.x0)[((size_t)b * T + t) * p.n_half + i];
      xc[h] = make_uint2(v[0] | (unsigned)v[1] << 16,
                         v[2] | (unsigned)v[3] << 16);
    }
  }
  float acc[128];
  for (int n0 = 0; n0 < p.rs_out; n0 += GN) {
    const int nn = min(GN, p.rs_out - n0);
    zero(acc);
    int prev = -1;
    for (int ks = 0; ks < C / BK; ++ks) {
      mbar_wait(&full[r.st], r.ph);
      const uint32_t s = smem_u32(ring + r.st * STAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int k = ks * BK + kk * 16;
        const uint64_t da =
            desc_a_gated(g + (k >> 6) * (BM * 128) + (k & 63) * 2);
        wgmma_n256<0, 1>(acc, da, desc_b<BK>(s + kk * 2048), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = r.st;
      r.next(p.stages);
    }
    wgmma_wait<0>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    if (ROLE == PART || ROLE == PART_FIRST) {
      part_store(p, b, t0, r0, q, n0, nn, acc);
      continue;
    }

    // epilogue in groups of NG column tiles: every load of a group (bias,
    // residual input or FIRST's base, running skip) is issued before its
    // stores, which may alias them as far as the compiler knows
#pragma unroll
    for (int jg = 0; jg < GN / 8; jg += NG) {
      if (8 * jg >= nn) break;
      float bias[NG][2];
      __nv_bfloat162 in[NG][2];
      float2 base[NG][2];   // FIRST: x0[t] start_k + start_b
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) {
        const int n = n0 + 8 * (jg + jj) + 2 * q;
        bias[jj][0] = p.b_rs[n];
        bias[jj][1] = p.b_rs[n + 1];
        if (ROLE == FIRST) {
          if (n < C) first_base(p, xc, n, base[jj]);
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r0 + 8 * h;
          const size_t row = ((size_t)b * T + t) * C;
          in[jj][h] = __floats2bfloat162_rn(0.f, 0.f);
          if (t < T) {
            if (has_res && n < C) {
              if (t < p.n_valid)
                in[jj][h] =
                    *reinterpret_cast<const __nv_bfloat162*>(p.x + row + n);
            } else {
              in[jj][h] = *reinterpret_cast<const __nv_bfloat162*>(
                  p.skip + row + (has_res ? n - C : n));
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) {
        const int j = jg + jj;
        const int n = n0 + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r0 + 8 * h;
          if (t >= T) continue;
          const float v0 = acc[4 * j + 2 * h] + bias[jj][0];
          const float v1 = acc[4 * j + 2 * h + 1] + bias[jj][1];
          const size_t row = ((size_t)b * T + t) * C;
          if (ROLE == FIRST) {
            if (n < C) {
              const bool ok = t < p.n_valid;
              *reinterpret_cast<__nv_bfloat162*>(p.x_out + row + n) =
                  __floats2bfloat162_rn(ok ? base[jj][h].x + v0 : 0.f,
                                        ok ? base[jj][h].y + v1 : 0.f);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(p.skip + row + n - C) =
                  __floats2bfloat162_rn(v0, v1);
            }
            continue;
          }
          const float i0 = __low2float(in[jj][h]), i1 = __high2float(in[jj][h]);
          if (has_res && n < C) {  // zero past n_valid: in[] is zero there
            const bool ok = t < p.n_valid;
            *reinterpret_cast<__nv_bfloat162*>(p.x_out + row + n) =
                __floats2bfloat162_rn(ok ? i0 + v0 : 0.f, ok ? i1 + v1 : 0.f);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(
                p.skip + row + (has_res ? n - C : n)) =
                __floats2bfloat162_rn(
                    i0 + __bfloat162float(__float2bfloat16(v0)),
                    i1 + __bfloat162float(__float2bfloat16(v1)));
          }
        }
      }
    }
  }
  if (ROLE == STD && !has_res) {  // skip-only: the hidden state passes
    const int cv = C / 8;
    for (int i = tid; i < 64 * cv; i += 128) {
      const int t = t0 + wg * 64 + i / cv;
      if (t >= T) break;
      const size_t o = ((size_t)b * T + t) * C + (i % cv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < p.n_valid) v = *reinterpret_cast<const uint4*>(p.x + o);
      *reinterpret_cast<uint4*>(p.x_out + o) = v;
    }
  }
}

// FINAL: acts W_rs' + skip_acc W_end + b' as FMAs.  A quad of threads
// takes two rows (r, r + 32 of the warpgroup's 64), each thread every
// fourth 8-column chunk, so that each weight it loads serves both rows;
// the quad's partial sums meet by shuffles.
template <int NWG>
__device__ __forceinline__ void final_phase(const Params& p, int wg, int tid,
                                            int b, int t0, const uint8_t* G) {
  constexpr int BM = NWG * 64;
  const int C = p.C, T = p.T, E = p.E, q = tid & 3;
  const bool pairs = (E & 1) == 0;  // w rows of E bf16 are 4-byte aligned
  int r[2], t[2];
  float s1[2][MAX_E], s2[2][MAX_E];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = wg * 64 + (tid >> 2) + 32 * h;
    t[h] = t0 + r[h];
#pragma unroll
    for (int e = 0; e < MAX_E; ++e) s1[h][e] = s2[h][e] = 0.f;
  }
  for (int ch = q; ch < C / 8; ch += 4) {
    uint4 gv[2], av[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gv[h] = *reinterpret_cast<const uint4*>(G + gated_off<BM>(r[h], ch * 8));
      av[h] = t[h] < T ? *reinterpret_cast<const uint4*>(
                             p.skip + ((size_t)b * T + t[h]) * C + ch * 8)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t w = (size_t)(ch * 8 + i) * E;
      float we[MAX_E], wd[MAX_E];
#pragma unroll
      for (int e = 0; e < MAX_E; e += 2) {
        if (pairs) {
          const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
          const __nv_bfloat162 x = e < E ? *reinterpret_cast<
              const __nv_bfloat162*>(p.w_eff + w + e) : zero2;
          const __nv_bfloat162 y = e < E ? *reinterpret_cast<
              const __nv_bfloat162*>(p.w_end + w + e) : zero2;
          we[e] = __low2float(x);
          we[e + 1] = __high2float(x);
          wd[e] = __low2float(y);
          wd[e + 1] = __high2float(y);
        } else {
#pragma unroll
          for (int u = e; u < e + 2; ++u) {
            we[u] = u < E ? __bfloat162float(p.w_eff[w + u]) : 0.f;
            wd[u] = u < E ? __bfloat162float(p.w_end[w + u]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float gf = __bfloat162float(
            reinterpret_cast<const bf16*>(&gv[h])[i]);
        const float af = __bfloat162float(
            reinterpret_cast<const bf16*>(&av[h])[i]);
#pragma unroll
        for (int e = 0; e < MAX_E; ++e) {
          s1[h][e] += gf * we[e];
          s2[h][e] += af * wd[e];
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < MAX_E; ++e) {
      s1[h][e] += __shfl_xor_sync(0xffffffffu, s1[h][e], 1);
      s1[h][e] += __shfl_xor_sync(0xffffffffu, s1[h][e], 2);
      s2[h][e] += __shfl_xor_sync(0xffffffffu, s2[h][e], 1);
      s2[h][e] += __shfl_xor_sync(0xffffffffu, s2[h][e], 2);
    }
    if (q == 0 && t[h] < T) {
      float* o = p.out + ((size_t)b * T + t[h]) * E;
#pragma unroll
      for (int e = 0; e < MAX_E; ++e)
        if (e < E) o[e] = s1[h][e] + s2[h][e] + p.b_eff[e];
    }
  }
}

template <int ROLE, int NWG, int BK, bool DCOND>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    wn_sm90_kernel(const __grid_constant__ Params p) {
  constexpr int BM = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* G = ring + p.stages * Tile<NWG, BK>::STAGE;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role for the whole kernel (setmaxnreg needs the paths
  // never to meet again).  With two consumer warpgroups the producer's
  // warpgroup gives registers to them: 2 x 128 x 216 + 128 x 72 of 65,536.
  if (warp >= NWG * 4) {  // producer warpgroup: one thread issues the loads
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x == NWG * 128)
      produce<ROLE, NWG, BK>(p, ring, full, empty, b, t0);
  } else {
    if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int wg = warp >> 2, tid = threadIdx.x & 127;
    // FIRST, PART_FIRST: the tap stage's A tile [BM, BK], after the gated
    // tile
    uint8_t* xa = G + (size_t)BM * p.C * 2;
    if (tap_stage_role(ROLE)) {
      // DCOND: one short stage a chunk hides little, so every chunk's
      // cond_all lines are asked for now
      if (DCOND)
        for (int c0 = 0; c0 < p.C; c0 += GHALF)
          prefetch_cond(p, wg, tid, b, t0, c0);
      stage_taps<BK>(p, wg, tid, b, t0, xa);
      // the warpgroup's tap rows -> visible to its wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    float acc[128];
    Ring r;
    for (int c0 = 0; c0 < p.C; c0 += GHALF) {
      inact_chunk<ROLE, NWG, BK, DCOND>(p, ring, full, empty, r, wg, tid,
                                        acc, b, t0, c0, xa);
      gate_store<ROLE, BM, DCOND>(p, b, t0, c0, wg, tid, acc, G);
    }
    // the warpgroup's gated rows -> visible to its wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (ROLE == FINAL)
      final_phase<NWG>(p, wg, tid, b, t0, G);
    else
      rs_phase<ROLE, NWG, BK>(p, ring, full, empty, r, wg, tid, b, t0, G);
  }
}

// --- host -------------------------------------------------------------------

CUtensorMapSwizzle a_swizzle(int bk) {
  return bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// The tap maps: x (T extent n_valid, width CX) and w_in [3CX, 2C].
int encode_taps(Params& p, const void* x, const void* w_in, int B, int bm,
                int bk) {
  const cuuint64_t C = p.C, CX = p.CX, T = p.T;
  const cuuint64_t nv = p.n_valid > 0 ? p.n_valid : 1;
  const cuuint32_t abox[3] = {(cuuint32_t)bk, (cuuint32_t)bm, 1};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)bk};
  int e;
  {
    const cuuint64_t dims[3] = {CX, nv, (cuuint64_t)B};
    const cuuint64_t str[2] = {CX * 2, T * CX * 2};
    if ((e = encode(&p.tm_x, x, 3, dims, str, abox, a_swizzle(bk))))
      return e;
  }
  const cuuint64_t dims[2] = {2 * C, 3 * CX};
  const cuuint64_t str[1] = {2 * C * 2};
  return encode(&p.tm_win, w_in, 2, dims, str, wbox,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// The conditioning's maps: spect and w_cond.
int encode_cond(Params& p, const void* spect, const void* w_cond, int B,
                int bm, int bk) {
  const cuuint64_t C = p.C, M = p.M, T = p.T;
  const cuuint32_t abox[3] = {(cuuint32_t)bk, (cuuint32_t)bm, 1};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)bk};
  int e;
  {
    const cuuint64_t dims[3] = {M, T, (cuuint64_t)B};
    const cuuint64_t str[2] = {M * 2, T * M * 2};
    if ((e = encode(&p.tm_spect, spect, 3, dims, str, abox, a_swizzle(bk))))
      return e;
  }
  const cuuint64_t dims[2] = {2 * C, M};
  const cuuint64_t str[1] = {2 * C * 2};
  return encode(&p.tm_wcond, w_cond, 2, dims, str, wbox,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// The maps of the in-kernel projection: the taps', spect and w_cond.
int encode_inact(Params& p, const void* x, const void* spect, const void* w_in,
                 const void* w_cond, int B, int bm, int bk) {
  const int e = encode_taps(p, x, w_in, B, bm, bk);
  return e ? e : encode_cond(p, spect, w_cond, B, bm, bk);
}

size_t stage_bytes(int nwg, int bk) {
  return (size_t)(4 * bk * 64 * 2 + nwg * 64 * bk * 2);
}

// the ring, the gated tile [BM, C] and, in FIRST and PART_FIRST, the tap
// stage's A tile [BM, BK]
size_t smem_bytes(int role, int nwg, int bk, int C, int stages) {
  return 1024 + (size_t)stages * stage_bytes(nwg, bk) +
         (size_t)nwg * 64 * C * 2 +
         (tap_stage_role(role) ? (size_t)nwg * 64 * bk * 2 : 0);
}

template <int ROLE, int NWG, int BK, bool DCOND>
int launch(const Params& p, int B, void* stream) {
  const size_t smem = smem_bytes(ROLE, NWG, BK, p.C, p.stages);
  cudaError_t e = cudaFuncSetAttribute(
      wn_sm90_kernel<ROLE, NWG, BK, DCOND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.T + NWG * 64 - 1) / (NWG * 64), B);
  wn_sm90_kernel<ROLE, NWG, BK, DCOND>
      <<<grid, (NWG + 1) * 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int ROLE, bool DCOND = false>
int dispatch(const Params& p, int B, int nwg, int bk, void* stream) {
  if (p.stages < 2 || p.stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  if (nwg == 2 && bk == 32) return launch<ROLE, 2, 32, DCOND>(p, B, stream);
  if (nwg == 2 && bk == 64) return launch<ROLE, 2, 64, DCOND>(p, B, stream);
  if (nwg == 1 && bk == 32) return launch<ROLE, 1, 32, DCOND>(p, B, stream);
  if (nwg == 1 && bk == 64) return launch<ROLE, 1, 64, DCOND>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

// STD's res/skip weight map: w_rs [C, rs_out].
int encode_wrs(Params& p, const void* w_rs, int bk) {
  const cuuint64_t dims[2] = {(cuuint64_t)p.rs_out, (cuuint64_t)p.C};
  const cuuint64_t str[1] = {(cuuint64_t)p.rs_out * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)bk};
  return encode(&p.tm_wrs, w_rs, 2, dims, str, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// FIRST, PART_FIRST: the tap stage's map, wp [3, n_half, 2C] as [3 n_half,
// 2C] rows; a box of 16 rows reads zeros past 3 n_half.
int encode_wp(Params& p, const void* wp) {
  const cuuint64_t dims[2] = {2 * (cuuint64_t)p.C, 3 * (cuuint64_t)p.n_half};
  const cuuint64_t str[1] = {(cuuint64_t)p.C * 4};
  const cuuint32_t box[2] = {64, TAP_ROWS};
  return encode(&p.tm_wp, wp, 2, dims, str, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

void fill_common(Params& p, int T, int n_valid, int C, int M, int d,
                 int stages, const void* x, const void* b_in,
                 const void* b_cond, const void* skip_acc) {
  p.T = T; p.n_valid = n_valid; p.C = C; p.CX = C; p.M = M; p.d = d;
  p.ktap = n_valid > 0 ? 3 * C : 0;
  p.stages = stages;
  p.x = (const bf16*)x;
  p.b_in = (const float*)b_in;
  p.b_cond = (const float*)b_cond;
  p.skip = (bf16*)skip_acc;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns 0 on success, a
// cudaError_t after the launch, or minus the CUresult of a refused tensor
// map.  `nwg` (consumer warpgroups: BM = 64 nwg rows), `bk` and `stages`
// are the launch plan of ops/wn_block.py; shapes, dtypes, contiguity and
// alignment are checked there before the call.
extern "C" {

// `role`: 0 standard, 1 final, 2 partial, 3 first, 4 partial first
size_t t2s_wn_sm90_smem_bytes(int nwg, int bk, int C, int stages, int role) {
  return smem_bytes(role, nwg, bk, C, stages);
}

int t2s_wn_layer_sm90(const void* x, const void* spect, const void* w_in,
                      const void* b_in, const void* w_cond, const void* b_cond,
                      const void* w_rs, const void* b_rs, void* skip_acc,
                      void* x_out, int B, int T, int n_valid, int C, int M,
                      int rs_out, int d, int nwg, int bk, int stages,
                      void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, M, d, stages, x, b_in, b_cond, skip_acc);
  p.rs_out = rs_out;
  p.b_rs = (const float*)b_rs;
  p.x_out = (bf16*)x_out;
  int e = encode_inact(p, x, spect, w_in, w_cond, B, 64 * nwg, bk);
  if (e || (e = encode_wrs(p, w_rs, bk))) return e;
  return dispatch<STD>(p, B, nwg, bk, stream);
}

// The standard layer of the composed-conditioning vocoder: K = 3C (no
// spect rows), the conditioning read from columns [cond_off, cond_off +
// 2C) of cond_all [B, T, cond_ld] in place; the skip sum in place.
int t2s_wn_layer_dcond_sm90(const void* x, const void* cond_all,
                            const void* w_in, const void* b_in,
                            const void* w_rs, const void* b_rs,
                            void* skip_acc, void* x_out, int B, int T,
                            int n_valid, int C, int cond_ld, int cond_off,
                            int rs_out, int d, int nwg, int bk, int stages,
                            void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, 0, d, stages, x, b_in, nullptr, skip_acc);
  p.rs_out = rs_out;
  p.b_rs = (const float*)b_rs;
  p.x_out = (bf16*)x_out;
  p.cond_all = (const bf16*)cond_all;
  p.cond_ld = cond_ld;
  p.cond_off = cond_off;
  int e = encode_taps(p, x, w_in, B, 64 * nwg, bk);
  if (e || (e = encode_wrs(p, w_rs, bk))) return e;
  return dispatch<STD, true>(p, B, nwg, bk, stream);
}

// One rank's share of a layer under tensor parallelism (layers 1..L-1):
// the hidden state x [B, T, CX], the rank's gate-paired columns w_in [3, CX,
// 2Cp] and w_cond [M, 2Cp] with b_in, b_cond [2Cp], its res/skip rows w_rs
// [Cp, rs_out]; out [B, T, rs_out] f32 is written whole.
int t2s_wn_layer_partial_sm90(const void* x, const void* spect,
                              const void* w_in, const void* b_in,
                              const void* w_cond, const void* b_cond,
                              const void* w_rs, void* out, int B, int T,
                              int n_valid, int CX, int Cp, int M, int rs_out,
                              int d, int nwg, int bk, int stages,
                              void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, Cp, M, d, stages, x, b_in, b_cond, nullptr);
  p.CX = CX;
  p.ktap = n_valid > 0 ? 3 * CX : 0;
  p.rs_out = rs_out;
  p.out = (float*)out;
  int e = encode_inact(p, x, spect, w_in, w_cond, B, 64 * nwg, bk);
  if (e || (e = encode_wrs(p, w_rs, bk))) return e;
  return dispatch<PART>(p, B, nwg, bk, stream);
}

// One rank's share of layer 0 under tensor parallelism: the audio half x0
// [B, T, n_half] bf16 under the rank's columns of the composed taps wp [3,
// n_half, 2Cp] bf16 with b_all and b_edge [2, 2Cp] f32 (fold_first_taps of
// the rank's w_in, b_in), w_cond [M, 2Cp] with b_cond [2Cp], its res/skip
// rows w_rs [Cp, rs_out]; out [B, T, rs_out] f32 is written whole.
int t2s_wn_layer_partial_first_sm90(const void* x0, const void* spect,
                                    const void* wp, const void* b_all,
                                    const void* b_edge, const void* w_cond,
                                    const void* b_cond, const void* w_rs,
                                    void* out, int B, int T, int n_valid,
                                    int n_half, int Cp, int M, int rs_out,
                                    int d, int nwg, int bk, int stages,
                                    void* stream) {
  if (n_half < 1 || n_half > MAX_NHALF) return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, Cp, M, d, stages, nullptr, b_all, b_cond,
              nullptr);
  p.ktap = 0;
  p.rs_out = rs_out;
  p.out = (float*)out;
  p.n_half = n_half;
  p.x0 = (const bf16*)x0;
  p.b_edge = (const float*)b_edge;
  int e = encode_cond(p, spect, w_cond, B, 64 * nwg, bk);
  if (e || (e = encode_wrs(p, w_rs, bk)) || (e = encode_wp(p, wp))) return e;
  return dispatch<PART_FIRST>(p, B, nwg, bk, stream);
}

// The final layer of the composed-conditioning vocoder: K = 3C (no spect
// rows), the conditioning read from columns [cond_off, cond_off + 2C) of
// cond_all [B, T, cond_ld] in place; skip_acc is read only.
int t2s_wn_layer_final_dcond_sm90(const void* x, const void* cond_all,
                                  const void* w_in, const void* b_in,
                                  const void* w_eff, const void* skip_acc,
                                  const void* w_end, const void* b_eff,
                                  void* out, int B, int T, int n_valid, int C,
                                  int cond_ld, int cond_off, int E, int d,
                                  int nwg, int bk, int stages, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, 0, d, stages, x, b_in, nullptr,
              const_cast<void*>(skip_acc));
  p.E = E;
  p.w_eff = (const bf16*)w_eff;
  p.w_end = (const bf16*)w_end;
  p.b_eff = (const float*)b_eff;
  p.out = (float*)out;
  p.cond_all = (const bf16*)cond_all;
  p.cond_ld = cond_ld;
  p.cond_off = cond_off;
  const int e = encode_taps(p, x, w_in, B, 64 * nwg, bk);
  if (e) return e;
  return dispatch<FINAL, true>(p, B, nwg, bk, stream);
}

// The first layer: the start projection composed onto layer 0's taps (x0
// [B, T, n_half] bf16 under wp [3, n_half, 2C] bf16 with b_all and b_edge
// [2, 2C] f32), the conditioning's product spect [B, T, M] x w_cond [M, 2C]
// + b_cond, the res/skip w_rs [C, 2C] + b_rs, the residual base start_k
// [n_half, C] bf16, start_b [C]; writes x_out and skip_out [B, T, C].
int t2s_wn_layer_first_sm90(const void* x0, const void* spect, const void* wp,
                            const void* b_all, const void* b_edge,
                            const void* w_cond, const void* b_cond,
                            const void* w_rs, const void* b_rs,
                            const void* start_k, const void* start_b,
                            void* x_out, void* skip_out, int B, int T,
                            int n_valid, int C, int M, int n_half, int d,
                            int nwg, int bk, int stages, void* stream) {
  if (n_half < 1 || n_half > MAX_NHALF) return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, M, d, stages, nullptr, b_all, b_cond,
              skip_out);
  p.ktap = 0;
  p.rs_out = 2 * C;
  p.b_rs = (const float*)b_rs;
  p.x_out = (bf16*)x_out;
  p.n_half = n_half;
  p.x0 = (const bf16*)x0;
  p.b_edge = (const float*)b_edge;
  p.start_k = (const bf16*)start_k;
  p.start_b = (const float*)start_b;
  int e = encode_cond(p, spect, w_cond, B, 64 * nwg, bk);
  if (e || (e = encode_wrs(p, w_rs, bk)) || (e = encode_wp(p, wp))) return e;
  return dispatch<FIRST>(p, B, nwg, bk, stream);
}

// The first layer of the composed-conditioning vocoder: as
// t2s_wn_layer_first_sm90, the conditioning read from columns [cond_off,
// cond_off + 2C) of cond_all [B, T, cond_ld] in place (no in-act product).
int t2s_wn_layer_first_dcond_sm90(const void* x0, const void* cond_all,
                                  const void* wp, const void* b_all,
                                  const void* b_edge, const void* w_rs,
                                  const void* b_rs, const void* start_k,
                                  const void* start_b, void* x_out,
                                  void* skip_out, int B, int T, int n_valid,
                                  int C, int cond_ld, int cond_off,
                                  int n_half, int d, int nwg, int bk,
                                  int stages, void* stream) {
  if (n_half < 1 || n_half > MAX_NHALF) return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, 0, d, stages, nullptr, b_all, nullptr,
              skip_out);
  p.ktap = 0;
  p.rs_out = 2 * C;
  p.b_rs = (const float*)b_rs;
  p.x_out = (bf16*)x_out;
  p.cond_all = (const bf16*)cond_all;
  p.cond_ld = cond_ld;
  p.cond_off = cond_off;
  p.n_half = n_half;
  p.x0 = (const bf16*)x0;
  p.b_edge = (const float*)b_edge;
  p.start_k = (const bf16*)start_k;
  p.start_b = (const float*)start_b;
  int e = encode_wrs(p, w_rs, bk);
  if (e || (e = encode_wp(p, wp))) return e;
  return dispatch<FIRST, true>(p, B, nwg, bk, stream);
}

int t2s_wn_layer_final_sm90(const void* x, const void* spect,
                            const void* w_in, const void* b_in,
                            const void* w_cond, const void* b_cond,
                            const void* w_eff, const void* skip_acc,
                            const void* w_end, const void* b_eff, void* out,
                            int B, int T, int n_valid, int C, int M, int E,
                            int d, int nwg, int bk, int stages,
                            void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, M, d, stages, x, b_in, b_cond,
              const_cast<void*>(skip_acc));
  p.E = E;
  p.w_eff = (const bf16*)w_eff;
  p.w_end = (const bf16*)w_end;
  p.b_eff = (const float*)b_eff;
  p.out = (float*)out;
  const int e = encode_inact(p, x, spect, w_in, w_cond, B, 64 * nwg, bk);
  if (e) return e;
  return dispatch<FINAL>(p, B, nwg, bk, stream);
}

}  // extern "C"
