// WaveGlow WN coupling layer in int8, standard, partial, final and first
// roles, redesigned for Hopper (sm_90a): s8 wgmma, TMA and 64-row tiles.
//
//   STD    replaces text2speech_tpu/ops/pallas/wn_block_int8.py:268
//          wn_layer_stream2_int8 (body _kernel_stream2_q, :141)
//   PART   replaces text2speech_tpu/ops/pallas/wn_block_int8.py:447
//          wn_layer_stream2_partial_int8 (body _kernel_stream2_partial_q,
//          :410), layers 1..L-1 of the tensor-parallel int8 vocoder
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block_int8.py:510
//          wn_layer_stream2_final_int8 (body _kernel_stream2_final_q, :220)
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block_int8.py:338
//          wn_layer_stream2_first_int8 (body _kernel_stream2_first_q, :178)
//
// The function is that of wn_block_int8.cu's STD role, for rows t of one
// utterance: hidden state qx [T, C] int8 with one f32 scale per row sx [T],
// grouped mel qspect [T, M] with sspect [T], int8 weights stored
// output-major ([N, K], k contiguous) with one f32 scale per output column
// (the three taps share sw_in):
//
//   taps[t]   = sum_j  s32(qx[t+(j-1)d] . qw_in[j]) * sx[t+(j-1)d]      f32
//   in_act[t] = taps[t] * sw_in + b_in
//               + s32(qspect[t] . qw_cond) * sspect[t] * sw_cond + b_cond
//   q[t]      = s8( rint( tanh(in_act[t,:C]) * sigmoid(in_act[t,C:]) * 127 ))
//   rs[t]     = s32(q[t] . qw_rs) * (sw_rs / 127) + b_rs                 f32
//   x_new[t]  = t < n_valid ? qx[t] * sx[t] + rs[t,:C] : 0
//   sx_new[t] = max(amax_c |x_new[t]|, 1e-12) / 127
//   qx_new[t] = s8( rint( x_new[t] / sx_new[t] ))      (a real division)
//   skip[t]   = bf16(skip_acc[t] + bf16(rs[t,C:]))          (in place)
//
// with qx rows outside [0, n_valid) read as zero in every tap.
// wn_block_int8.cu keeps the first design of this role and of the other
// three (64-row blocks, mma.sync s8, cp.async, halo rows gathered by hand);
// its entry points stay exported so that the two designs can be timed side
// by side, and nothing else calls them.
//
// What bounds the layer on an H100.  At B=1, T=6400, C=512, M=640 it is
// 35.2 GOP of s8 products against ~27 MB of activations and 2.7 MB of
// weights: 0.0178 ms at the 1,979 TOP/s int8 peak, bound by operations.
// The first design reached ~6% of that: mma.sync (wgmma is the only route
// to the peak), 64-row blocks that each stream the layer's weights from
// L2, and every thread issuing cp.async loads.
//
// Design.  A block owns 64 rows of one utterance.  It is warp-specialised:
// one producer warpgroup, one thread of which issues every load, and NC =
// 2 consumer warpgroups (column groups) on the same 64 rows, or 1 where
// three ring stages of two would not fit beside the gated tile (C > 1664);
// the host plan (ops/wn_block_int8.py int8_sm90_plan) chooses, and its
// constants are held to this file's by t2s_wn_int8_sm90_smem_bytes.
//
// * s8 wgmma (m64n128k32 s32.s8.s8) takes A and B K-major only: there is no
//   transpose for 8-bit types.  The port already stores the int8 weights
//   [N, K] with k contiguous, and qx, qspect and the gated tile are [rows,
//   K]: every operand is K-major as stored, and no layout changes.  A ring
//   stage is K = 128 bytes deep, one 128-byte swizzled row of each operand:
//   the [64, 128] activation tile and one [128, 128] weight tile (two
//   64-row TMA boxes) per consumer warpgroup; four k32 steps.
// * The taps are three TMA boxes of qx at rows t0-d, t0, t0+d from a tensor
//   map whose T extent is n_valid: the out-of-bounds zero fill is the
//   conv's zero padding at the true length, negative rows included.  A
//   zero-filled row gives an s32 partial of exactly 0 whatever its scale;
//   the scale each thread reads for such a row is 0 and does not leave sx.
//   qspect and w_cond boxes past M are zero-filled alike (M % 128 != 0).
// * Per-tap scales.  A gate chunk is 64 tanh + the matching 64 sigmoid
//   columns (N = 128) and runs four s32 accumulations (K = C, C, C, M).  At
//   the end of each tap the warpgroup's wgmma queue drains and the s32 sums
//   are flushed into an f32 sum with the scale of that tap's shifted row
//   (separate multiply and add, in the plain version's order); the next
//   tap starts its accumulator with scale-d = 0.  So two register sets are
//   live, 64 s32 and 64 f32 a thread: at N = 256 they would need 256
//   registers, more than setmaxnreg can give a consumer beside the
//   producer.  The conditioning's s32 sums stay in the accumulator for the
//   gate.
// * Two column groups.  The warpgroups take alternate gate chunks (columns
//   c0 and c0 + 64 of each stage's pair) from the activation tile they
//   share, so the K = 3C + M operand is loaded C / 128 times per block, and
//   one warpgroup's drains, flushes, gate and epilogues overlap the other's
//   products: with one warpgroup on 64 rows, or two on 128 rows, nothing
//   hid them, and both ran slower at batch 1 and 3 (PERF.md).
// * The gate runs in f32 (tanhf, expf and a division, as the first
//   design), is quantized to s8 at 127 with rint and stored into the gated
//   tile [64, C] s8 in shared memory: 128-column panels with the 128-byte
//   swizzle that the res/skip wgmma reads as its K-major A operand.  Both
//   warpgroups read all of it, so they meet at a barrier before the
//   res/skip product.
// * The res/skip product [64, C] x [C, 2C] runs in chunks of N = 128, the
//   warpgroups taking alternate ones, the residual chunks first.  The
//   requantization needs each row's amax over all C residual columns: each
//   thread keeps a running max over its columns, the quad that shares its
//   rows reduces it by shuffles, and the two warpgroups exchange theirs
//   through shared memory at a barrier after the last chunk.  The values
//   wait for it in an f32 scratch buffer in global memory ([B, T, C], from
//   the wrapper), as in the first design: a thread reads back exactly the
//   elements it wrote itself (program order, no barrier), from L2, and
//   quantizes them with x / s.  Kept rather than replaced: 128 KB a block
//   at C = 512 would leave no room for the ring in shared memory; in
//   registers they would take 128 a thread; recomputing the residual
//   chunks would add 10% of the layer's products and stream their weights
//   twice.  The skip chunks update the bf16 skip sum in place: a block
//   reads and writes its own rows only.
// * Epilogues issue their global loads before their stores: a store
//   through a byte pointer may alias any load, and interleaved, every load
//   waited for the store before it (PERF.md).
// * Registers: with two consumer warpgroups the block is 384 threads, 168
//   registers each at launch (setmaxnreg gives the consumers 216 and the
//   producer 72).  ptxas fits the kernel in 168 with a few spills; the
//   residual epilogue works in halves of its chunk, which cut them from
//   160 to 48 bytes (PERF.md).  With one warpgroup it takes 254.
//
// Every block still streams all 2.7 MB of the layer's int8 weights from L2
// (100 blocks at one utterance of 6400 rows).  Measured times are in
// PERF.md.
//
// PART.  One rank's share of a layer under tensor parallelism: the hidden
// state's width CX (the taps' K) and the rank's gate width Cp (its
// gate-paired columns of qw_in [3, 2Cp, CX] and qw_cond [2Cp, M], with its
// own column scales; the res/skip K) are two widths, and the kernel's C
// is Cp:
//
//   part[t] = t < n_valid ? s32(q[t] . qw_rs) * (sw_rs / 127) : 0  [rs_out]
//
// f32, with qw_rs [rs_out, Cp] the rank's rows and sw_rs its own scales, so
// the ranks' partials add on one scale: no bias, residual, amax,
// requantization, x_new scratch or skip sum (they follow the sum over
// ranks).  The mainloop is the standard layer's.  At Cp % 128 == 64 the
// last gate chunk pair has one chunk: the second column group sits out its
// in-act product (the producer loads no weight tile for it, and it passes
// the ring's stages on), so at p = 8 (Cp = 64) the second warpgroup only
// shares the res/skip chunks: int8_sm90_plan keeps two column groups there,
// which a timed tile line found within 3% of one, ahead at batch 3
// (PERF.md).  The res/skip K = Cp may be below one 128-byte stage: the
// gated tile is whole 128-column panels, and the qw_rs boxes past Cp are
// TMA's zero fill, so the panel's unwritten columns multiply zeros.  The
// epilogue writes the f32 partial whole, zero at rows >= n_valid: the
// chunk's column scales are loaded before its K loop, and the two threads
// of a quad pair swap a row's pair of columns by a shuffle, so that each
// stores four consecutive floats of one row as one 16-byte vector.  At
// p = 4, B=1, T=6400 the call is 8.8 GOP against ~34 MB, 26 MB of it the
// f32 output: 0.0102 ms at 3.35 TB/s, bound by bytes.  The register path's
// stores are kept: at p = 8, 4 and 2 (the same output, in-act work 1 : 2 :
// 4) the call grows with the in-act product, not with the stores, so a TMA
// store of each [64, 128] f32 chunk from shared memory is untried
// (PERF.md).
//
// FINAL.  The last layer of a flow: the in-act product and its mainloop
// are the standard layer's, the gate is cast to bf16 (not quantized), and
// the res/skip product is folded into the rank-E end projection (E <= 8):
//
//   out[t] = bf16(gate[t]) w_eff + skip_acc[t] w_end + b_eff     [E], f32
//
// as FMAs in the gate stage, on the (row, column) pairs each thread's
// accumulator holds: no gated tile, res/skip product, residual, amax or
// scratch.  w_eff and w_end are staged once per block as [C, 8] bf16
// tables (zero past E) in the gated tile's place, so a thread reads a
// column's eight weights as one 16-byte load.  Each column group sums
// its own gate chunks (its skip columns are its gate columns: the
// skip_acc w_end term is split between the groups alike) into [64, 8] f32
// in shared memory: after each chunk the quad that shares a thread's rows
// reduces its partial sums by shuffles and adds them there.  The two
// groups meet once, and the block's [64, E] rows are stored as one
// contiguous run.  With the gated tile gone the ring is one stage deeper
// (five at C = 512).
//
// FIRST.  Layer 0 of a flow, on the audio half x0 [T, n_half <= 4] bf16:
//
//   taps[t]   = sum_j x0[t+(j-1)d] wp[j]          (rank n_half, f32 sums)
//   in_act[t] = taps[t] + b_all + s32(qspect[t] . qw_cond) * sspect[t]
//               * sw_cond + b_cond,  minus b_edge[0] where t < d and
//               b_edge[1] where t >= n_valid - d
//   x_new[t]  = t < n_valid ? x0[t] start_k + start_b + rs[t,:C] : 0
//   skip[t]   = bf16(rs[t,C:])                                 (written)
//
// with q, rs and the requantization as in STD and x0 rows outside [0,
// n_valid) read as zero.  The in-act product is the conditioning alone (K
// = M, five stages at M = 640; the producer loads no tap boxes), and the
// rank-n_half taps are f32 FMAs in the gate stage on each thread's
// accumulator pairs: the block's three tap rows of x0 per row are staged
// once in shared memory (3 KB; kept in registers, the 24 floats spilled),
// the chunk's columns of wp are read as bf16 pairs, every load issued
// without a branch (behind a branch on n_half each load waited for the one
// before it, and the layer ran slower than its first design at batch 3),
// then come b_all, the conditioning and the edge take-back in the plain
// version's order.  The res/skip product, the amax meeting and the
// requantization are STD's; the residual base is x0[t] start_k + start_b
// by FMAs.
//
// A wait on an mbarrier that does not complete within seconds traps (a
// launch error) instead of hanging the card.

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;               // rows per block
constexpr int QN = 128;              // columns per product chunk
constexpr int QH = QN / 2;           // gate chunk: 64 tanh + 64 sigmoid
constexpr int QK = 128;              // int8 k (bytes) per ring stage
constexpr int MAX_STAGES = 6;
constexpr int A_BYTES = BM * QK;     // the [64, 128] activation tile
constexpr int B_BOX = 64 * QK;       // one [64 rows, 128 k] weight box
constexpr int B_STAGE = 2 * B_BOX;   // the [128, 128] weight tile
constexpr float INV127 = (float)(1.0 / 127.0);

// NC consumer warpgroups (column groups) on the block's 64 rows: a stage
// holds NC weight tiles, one per warpgroup's chunk, and the activation tile
// they share.
template <int NC>
struct QTile {
  static constexpr int B_BYTES = NC * B_STAGE;
  static constexpr int STAGE = B_BYTES + A_BYTES;
};

constexpr int MAX_E = 8;          // FINAL: end projection columns
constexpr int MAX_NHALF = 4;      // FIRST: audio half channels

enum Role { STD = 0, PART = 1, FINAL = 2, FIRST = 3 };

struct QParams {
  CUtensorMap tm_qx;      // qx as [B, n_valid, CX]; box {128, BM, 1}
  CUtensorMap tm_qspect;  // qspect [B, T, M]; box {128, BM, 1}
  CUtensorMap tm_win;     // qw_in as [3 * 2C, CX]; box {128, 64}
  CUtensorMap tm_wcond;   // qw_cond [2C, M]; box {128, 64}
  CUtensorMap tm_wrs;     // qw_rs [rs_out, C]; box {128, 64}
  int T, n_valid, C, M, d, stages;
  int CX;                 // the hidden state's width: C except in PART
  int rs_out;             // res/skip columns: 2C in STD and FIRST, 0 in FINAL
  int ntap;               // K stages of one tap (CX / 128); 0 if n_valid == 0
                          // and in FIRST
  int ncond;              // K stages of the conditioning: ceil(M / 128)
  int nrs;                // K stages of the res/skip product: ceil(C / 128)
  int E;                  // FINAL: end projection columns
  int n_half;             // FIRST: audio half channels
  const int8_t* qx;       // [B, T, CX]
  const float* sx;        // [B, T]
  const float* sspect;    // [B, T]
  const float* sw_in;     // [2C]
  const float* b_in;      // [2C] (FIRST: b_all, b_in + the folded tap bias)
  const float* sw_cond;   // [2C]
  const float* b_cond;    // [2C]
  const float* sw_rs;     // [2C]
  const float* b_rs;      // [2C]
  bf16* skip;             // [B, T, C] STD: running skip sum, updated in
                          // place; FINAL: read; FIRST: written
  float* xn;              // [B, T, C] scratch for x_new
  int8_t* qx_out;         // [B, T, C]
  float* sx_out;          // [B, T]
  float* out;             // PART: [B, T, rs_out]; FINAL: [B, T, E]
  const bf16* x0;         // FIRST: [B, T, n_half]
  const bf16* wp;         // FIRST: composed taps [3, n_half, 2C]
  const float* b_edge;    // FIRST: [2, 2C] (left, right)
  const bf16* start_k;    // FIRST: [n_half, C]
  const float* start_b;   // FIRST: [C]
  const bf16* w_eff;      // FINAL: w_rs @ w_end [C, E]
  const bf16* w_end;      // FINAL: [C, E]
  const float* b_eff;     // FINAL: b_rs @ w_end + b_end [E]
};

// K-major operand with 128-byte rows and the 128-byte swizzle: 8-row
// groups 1024 bytes apart.  A k32 step advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}

// wgmma m64n128k32, s32 += s8 x s8, A and B K-major from shared memory.
// d holds 64 s32: tile j (columns 8j..8j+7) in d[4j..4j+3], rows lane/4
// (d[4j], d[4j+1]) and lane/4 + 8 (d[4j+2], d[4j+3]) of the warp's 16,
// columns 2 (lane % 4) + {0, 1} (the f32 layout).  scale_d = 0 ignores d.
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// tanh(at) * sigmoid(as) in f32, as the first design computes it
__device__ __forceinline__ float gate_q(float at, float as) {
  return tanhf(at) * (1.f / (1.f + expf(-as)));
}

// The conditioning's term of one in-act value: (cond * sspect) * sw_cond +
// b_cond, the plain version's order.
__device__ __forceinline__ float cond_q(int cond, float ss, float wc,
                                        float bc) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(cond), ss), wc), bc);
}

// One in-act value of the int8 taps: taps * sw_in + b_in, plus the
// conditioning's term.
__device__ __forceinline__ float inact_q(float taps, float sw, float bi,
                                         int cond, float ss, float wc,
                                         float bc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(taps, sw), bi),
                   cond_q(cond, ss, wc, bc));
}

// Eight bf16 (one 16-byte load) as floats, element 0 the low half of v.x.
__device__ __forceinline__ void unpack_bf16x8(const uint4& v,
                                              float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The low (e = 0) or high (e = 1) bf16 of a pair as a float.
__device__ __forceinline__ float bf16_half(unsigned pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

// Byte offset of (row r, column c) in the s8 gated tile: 128-column panels
// of 64 rows x 128 bytes, 16-byte chunks swizzled by the row (what TMA's
// 128-byte swizzle gives, and wgmma's K-major A expects).
__device__ __forceinline__ uint32_t gated_off(int r, int c) {
  return (uint32_t)((c >> 7) * (BM * QK) + r * QK +
                    ((((c & 127) >> 4) ^ (r & 7)) << 4) + (c & 15));
}

// --- producer ---------------------------------------------------------------

// PART: the column groups that have a chunk at c0 of a width of `width`
// columns in chunks of `chunk` (the others sit it out); STD: all of them.
template <int ROLE, int NC>
__device__ __forceinline__ int groups_on(int c0, int width, int chunk) {
  return ROLE == PART ? min(NC, (width - c0) / chunk) : NC;
}

template <int ROLE, int NC>
__device__ __forceinline__ void produce(const QParams& p, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int b, int t0) {
  using TL = QTile<NC>;
  const int C = p.C;
  Ring r;
  for (int c0 = 0; c0 < C; c0 += QH * NC) {
    // the chunks' K order: tap 0, 1, 2 (CX each), then the conditioning;
    // column group g's chunk starts at column c0 + 64 g
    const int ng = groups_on<ROLE, NC>(c0, C, QH);
    for (int ks = 0; ks < 3 * p.ntap + p.ncond; ++ks) {
      mbar_wait(&empty[r.st], r.ph ^ 1);
      uint8_t* slot = ring + r.st * TL::STAGE;
      uint64_t* bar = &full[r.st];
      mbar_expect_tx(bar, A_BYTES + ng * B_STAGE);
      const bool tap = ks < 3 * p.ntap;
      const int j = tap ? ks / p.ntap : 0;
      const int k0 = (tap ? ks - j * p.ntap : ks - 3 * p.ntap) * QK;
      const CUtensorMap* wm = tap ? &p.tm_win : &p.tm_wcond;
      const int wrow = tap ? j * 2 * C : 0;
      if (tap)
        tma_load_3d(slot + TL::B_BYTES, &p.tm_qx, k0, t0 + (j - 1) * p.d, b,
                    bar);
      else
        tma_load_3d(slot + TL::B_BYTES, &p.tm_qspect, k0, t0, b, bar);
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        if (g >= ng) break;
        const int c = c0 + QH * g;
        tma_load_2d(slot + g * B_STAGE, wm, k0, wrow + c, bar);
        tma_load_2d(slot + g * B_STAGE + B_BOX, wm, k0, wrow + C + c, bar);
      }
      r.next(p.stages);
    }
  }
  // the res/skip weights: K = C in ceil(C / 128) stages, a last one past
  // C zero-filled (TMA counts a whole box either way)
  for (int n0 = 0; n0 < p.rs_out; n0 += QN * NC) {
    const int ng = groups_on<ROLE, NC>(n0, p.rs_out, QN);
    for (int ks = 0; ks < p.nrs; ++ks) {
      mbar_wait(&empty[r.st], r.ph ^ 1);
      uint8_t* slot = ring + r.st * TL::STAGE;
      uint64_t* bar = &full[r.st];
      mbar_expect_tx(bar, ng * B_STAGE);
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        if (g >= ng) break;
        tma_load_2d(slot + g * B_STAGE, &p.tm_wrs, ks * QK, n0 + QN * g, bar);
        tma_load_2d(slot + g * B_STAGE + B_BOX, &p.tm_wrs, ks * QK,
                    n0 + QN * g + 64, bar);
      }
      r.next(p.stages);
    }
  }
}

// --- consumers --------------------------------------------------------------

// PART: a column group that sits out a chunk passes its n ring stages on:
// it waits for each to fill (so that its arrival counts for this round of
// the slot, not the one before) and frees it.
__device__ __forceinline__ void pass_stages(uint64_t* full, uint64_t* empty,
                                            Ring& r, int n, int tid,
                                            int stages) {
  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[r.st], r.ph);
    if (tid == 0) mbar_arrive(&empty[r.st]);
    r.next(stages);
  }
}

// The in-act product of one gate chunk of column group cg for the block's
// 64 rows.  On return tsum holds the three taps' f32 sum (each tap's s32
// sums times the scale of its shifted row: st[tap][h] for rows r0 + 8h)
// and acc the conditioning's s32 sums.
// FIRST has no tap stages (ntap = 0): acc alone, tsum is not touched.
template <int ROLE, int NC>
__device__ __forceinline__ void inact_chunk(const QParams& p, uint8_t* ring,
                                            uint64_t* full, uint64_t* empty,
                                            Ring& r, int cg, int tid,
                                            int* acc, float* tsum,
                                            const float (&st)[3][2]) {
  using TL = QTile<NC>;
  const int nkt = ROLE == FIRST ? 0 : 3 * p.ntap, nk = nkt + p.ncond;
  if (ROLE != FIRST) {
#pragma unroll
    for (int i = 0; i < 64; ++i) tsum[i] = 0.f;
  }
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks) {
    mbar_wait(&full[r.st], r.ph);
    const uint32_t s = smem_u32(ring + r.st * TL::STAGE);
    const uint32_t a = s + TL::B_BYTES;
    const uint32_t w = s + cg * B_STAGE;
    const bool first = ks < nkt ? ks % p.ntap == 0 : ks == nkt;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK / 32; ++kk)
      wgmma_s8_n128(acc, desc_k128(a + kk * 32), desc_k128(w + kk * 32),
                    first && kk == 0 ? 0 : 1);
    wgmma_commit();
    if (ROLE != FIRST && ks < nkt && (ks + 1) % p.ntap == 0) {
      // the end of a tap: drain, free both slots, flush with the scales
      wgmma_wait<0>();
      if (tid == 0) {
        if (prev >= 0) mbar_arrive(&empty[prev]);
        mbar_arrive(&empty[r.st]);
      }
      prev = -1;
      const int j = ks / p.ntap;
      const float s0 = j == 0 ? st[0][0] : j == 1 ? st[1][0] : st[2][0];
      const float s1 = j == 0 ? st[0][1] : j == 1 ? st[1][1] : st[2][1];
#pragma unroll
      for (int i = 0; i < 64; ++i)
        tsum[i] = __fadd_rn(tsum[i],
                            __fmul_rn(__int2float_rn(acc[i]), i & 2 ? s1 : s0));
    } else {
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = r.st;
    }
    r.next(p.stages);
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
}

// Gate one chunk in f32, quantize at 127 and store s8 into the gated tile.
// The sums in the plain version's order: taps * sw_in + b_in, then
// (cond * sspect) * sw_cond + b_cond, then their sum.  Every pair is
// computed before the first store: a store through a byte pointer may
// alias any load, and the compiler would issue each parameter load after
// the previous store.
__device__ __forceinline__ void gate_store(const QParams& p, int c0, int tid,
                                           const int* acc, const float* tsum,
                                           const float (&ss)[2], uint8_t* G) {
  const int lane = tid & 31, q = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int C = p.C;
  unsigned short pairs[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + 8 * j + 2 * q;
    unsigned v[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ct = c + e, cs = C + c + e;
      const float swt = __ldg(p.sw_in + ct), sws = __ldg(p.sw_in + cs);
      const float bit = __ldg(p.b_in + ct), bis = __ldg(p.b_in + cs);
      const float wct = __ldg(p.sw_cond + ct), wcs = __ldg(p.sw_cond + cs);
      const float bct = __ldg(p.b_cond + ct), bcs = __ldg(p.b_cond + cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e, k = 4 * (j + 8) + 2 * h + e;
        const float g =
            gate_q(inact_q(tsum[i], swt, bit, acc[i], ss[h], wct, bct),
                   inact_q(tsum[k], sws, bis, acc[k], ss[h], wcs, bcs));
        v[h][e] = (unsigned)__float2int_rn(__fmul_rn(g, 127.f)) & 0xffu;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pairs[j][h] = (unsigned short)(v[h][0] | (v[h][1] << 8));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned short*>(
          G + gated_off(r0 + 8 * h, c0 + 8 * j + 2 * q)) = pairs[j][h];
}

// FIRST: gate one chunk as gate_store does, the in-act sums being the
// rank-n_half taps (FMAs of the block's tap rows of x0, sX [64][3][4] f32 in
// shared memory, zero outside [0, n_valid) and past n_half, with the
// chunk's columns of wp read as bf16 pairs) plus b_all, plus the
// conditioning's term, minus the folded start bias where the left or the
// right tap reads past an edge: the plain version's order after the taps.
__device__ __forceinline__ void gate_store_first(
    const QParams& p, int c0, int tid, int t0, const int* acc,
    const float* sX, const float (&ss)[2], uint8_t* G) {
  const int lane = tid & 31, q = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int C = p.C, nh = p.n_half;
  bool left[2], right[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
    left[h] = t < p.d;
    right[h] = t >= p.n_valid - p.d;
  }
  unsigned short pairs[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + 8 * j + 2 * q;
    float tp[2][2][2];   // [row][tanh, sigmoid][column of the pair]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) tp[h][u][0] = tp[h][u][1] = 0.f;
    // every load is issued (rows past n_half repeat the last one, against
    // an x0 value of 0), so none waits behind a branch
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      float4 xr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xr[h] = *reinterpret_cast<const float4*>(
            sX + ((r0 + 8 * h) * 3 + jj) * MAX_NHALF);
#pragma unroll
      for (int i = 0; i < MAX_NHALF; ++i) {
        const unsigned* w = reinterpret_cast<const unsigned*>(
            p.wp + (size_t)(jj * nh + min(i, nh - 1)) * 2 * C + c);
        const unsigned wt = __ldg(w), ws = __ldg(w + C / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = i == 0 ? xr[h].x : i == 1 ? xr[h].y
                        : i == 2 ? xr[h].z : xr[h].w;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            tp[h][0][e] = fmaf(x, bf16_half(wt, e), tp[h][0][e]);
            tp[h][1][e] = fmaf(x, bf16_half(ws, e), tp[h][1][e]);
          }
        }
      }
    }
    unsigned v[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ct = c + e, cs = C + ct;
      const float bat = __ldg(p.b_in + ct), bas = __ldg(p.b_in + cs);
      const float wct = __ldg(p.sw_cond + ct), wcs = __ldg(p.sw_cond + cs);
      const float bct = __ldg(p.b_cond + ct), bcs = __ldg(p.b_cond + cs);
      const float elt = __ldg(p.b_edge + ct), els = __ldg(p.b_edge + cs);
      const float ert = __ldg(p.b_edge + 2 * C + ct);
      const float ers = __ldg(p.b_edge + 2 * C + cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e, k = 4 * (j + 8) + 2 * h + e;
        float at = __fadd_rn(__fadd_rn(tp[h][0][e], bat),
                             cond_q(acc[i], ss[h], wct, bct));
        float as = __fadd_rn(__fadd_rn(tp[h][1][e], bas),
                             cond_q(acc[k], ss[h], wcs, bcs));
        if (left[h]) {
          at = __fsub_rn(at, elt);
          as = __fsub_rn(as, els);
        }
        if (right[h]) {
          at = __fsub_rn(at, ert);
          as = __fsub_rn(as, ers);
        }
        v[h][e] = (unsigned)__float2int_rn(__fmul_rn(gate_q(at, as), 127.f))
                  & 0xffu;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pairs[j][h] = (unsigned short)(v[h][0] | (v[h][1] << 8));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned short*>(
          G + gated_off(r0 + 8 * h, c0 + 8 * j + 2 * q)) = pairs[j][h];
}

// FINAL: one gate chunk (columns c0 .. c0 + 63 and their sigmoid partners)
// in f32, cast to bf16, times the chunk's rows of w_eff, plus the running
// skip sum's columns c0 .. c0 + 63 times w_end's, into partial sums fs
// [2 rows][8]; the quad that shares the rows reduces them by shuffles and
// adds them to the column group's [64, 8] sums in shared memory (`fin`,
// each element owned by one thread).  W holds w_eff and then w_end as
// [C, 8] bf16 tables, zero past E.  Registers: the 32 gate values are
// computed first, which frees the 128 accumulator registers, and only then
// are the skip pairs loaded and the partial sums kept (interleaved, they
// spilled at two column groups' 168 registers).
__device__ __forceinline__ void final_accum(const QParams& p, int c0, int tid,
                                            int b, int t0, const int* acc,
                                            const float* tsum,
                                            const float (&ss)[2],
                                            const uint8_t* W, float* fin) {
  const int lane = tid & 31, q = lane & 3;
  const int rl = (tid >> 5) * 16 + (lane >> 2);
  const int C = p.C;
  float gb[8][2][2];   // [tile][column of the pair][row]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ct = c0 + 8 * j + 2 * q + e, cs = C + ct;
      const float swt = __ldg(p.sw_in + ct), sws = __ldg(p.sw_in + cs);
      const float bit = __ldg(p.b_in + ct), bis = __ldg(p.b_in + cs);
      const float wct = __ldg(p.sw_cond + ct), wcs = __ldg(p.sw_cond + cs);
      const float bct = __ldg(p.b_cond + ct), bcs = __ldg(p.b_cond + cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e, k = 4 * (j + 8) + 2 * h + e;
        const float g =
            gate_q(inact_q(tsum[i], swt, bit, acc[i], ss[h], wct, bct),
                   inact_q(tsum[k], sws, bis, acc[k], ss[h], wcs, bcs));
        gb[j][e][h] = __bfloat162float(__float2bfloat16(g));
      }
    }
  }
  unsigned sk[8][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + rl + 8 * h;
    const unsigned* row = reinterpret_cast<const unsigned*>(
        p.skip + ((size_t)b * p.T + t) * C + c0 + 2 * q);
#pragma unroll
    for (int j = 0; j < 8; ++j) sk[j][h] = t < p.T ? __ldg(row + 4 * j) : 0u;
  }
  float fs[2][MAX_E];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < MAX_E; ++u) fs[h][u] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ct = c0 + 8 * j + 2 * q + e;
      float we[MAX_E], wd[MAX_E];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(W + (size_t)ct * 16), we);
      unpack_bf16x8(
          *reinterpret_cast<const uint4*>(W + (size_t)(C + ct) * 16), wd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = bf16_half(sk[j][h], e);
#pragma unroll
        for (int u = 0; u < MAX_E; ++u)
          fs[h][u] = fmaf(a, wd[u], fmaf(gb[j][e][h], we[u], fs[h][u]));
      }
    }
  }
  // lane q of the quad adds columns 2q, 2q + 1 (static indices only)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < MAX_E; ++u) {
      float v = fs[h][u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((u >> 1) == q) fin[(rl + 8 * h) * MAX_E + u] += v;
    }
}

// FINAL, after the last chunk: the column groups' sums meet, and the first
// group writes out = sums + b_eff, the block's [64, E] f32 rows (one
// contiguous run of memory) an element a thread.
template <int NC>
__device__ __forceinline__ void final_store(const QParams& p, int cg, int tid,
                                            int b, int t0, const float* fin) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(NC * 128) : "memory");
  if (cg != 0) return;
  const int E = p.E;
  const int rows = min(BM, p.T - t0);
  float* o = p.out + ((size_t)b * p.T + t0) * E;
  for (int i = tid; i < rows * E; i += 128) {
    const int r = i / E, u = i - r * E;
    float v = fin[r * MAX_E + u];
    if (NC == 2) v += fin[(BM + r) * MAX_E + u];
    o[i] = v + __ldg(p.b_eff + u);
  }
}

// FIRST: the residual base x0[t] start_k + start_b at columns n, n + 1 (n
// even), from the row's x0 (xc: its centre tap row in sX, zero past
// n_half); the plain version's order: the product, then the bias.
__device__ __forceinline__ void first_base(const QParams& p, const float* xc,
                                           int n, float& base0,
                                           float& base1) {
  const float4 x4 = *reinterpret_cast<const float4*>(xc);
  const float x[MAX_NHALF] = {x4.x, x4.y, x4.z, x4.w};
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_NHALF; ++i) {   // branch-free, as the taps
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
        p.start_k + (size_t)min(i, p.n_half - 1) * p.C + n));
    s0 = fmaf(x[i], bf16_half(w, 0), s0);
    s1 = fmaf(x[i], bf16_half(w, 1), s1);
  }
  base0 = __fadd_rn(s0, __ldg(p.start_b + n));
  base1 = __fadd_rn(s1, __ldg(p.start_b + n + 1));
}

// The res/skip product in chunks of N = 128, A from the gated tile: each
// warpgroup takes the chunks n0 + 128 cg (column group cg of NC).  The
// residual chunks park x_new in the scratch and keep each row's running
// amax; the skip chunks update the running skip sum.  After the last chunk
// the rows are requantized: the quad that shares a row reduces its amax
// by shuffles, two column groups exchange theirs through `xamax` [2][64]
// in shared memory, and each warpgroup quantizes the columns it parked.
// sc[h] is sx of rows r0 + 8h (0 past n_valid).  Each epilogue issues all
// of its global loads (the chunk's qx pairs or running skip sums, the
// parked values) before its first store, and the chunk's are issued before
// its K loop, so their latency hides behind the products: interleaved with
// stores, every load would wait for the store before it, which may alias
// it.  FIRST: the residual base is x0[t] start_k + start_b from the
// block's x0 rows (sX), and the skip chunks write bf16(rs) (no running
// sum).
template <int ROLE, int NC>
__device__ __forceinline__ void rs_phase(const QParams& p, uint8_t* ring,
                                         uint64_t* full, uint64_t* empty,
                                         Ring& r, int cg, int tid, int b,
                                         int t0, const uint8_t* G,
                                         float* xamax, const float (&sc)[2],
                                         const float* sX) {
  using TL = QTile<NC>;
  const int C = p.C, T = p.T;
  const uint32_t g = smem_u32(G);
  const int lane = tid & 31, q = lane & 3;
  const int rl = (tid >> 5) * 16 + (lane >> 2);   // the row in the block
  size_t row[2];
  int t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t[h] = t0 + rl + 8 * h;
    row[h] = ((size_t)b * T + t[h]) * C;
  }
  float amax[2] = {0.f, 0.f};
  int acc[64];
  for (int n0 = 0; n0 < 2 * C; n0 += QN * NC) {
    const int nc = n0 + QN * cg;   // this warpgroup's chunk
    // the chunk's epilogue inputs: qx pairs (residual) or the running skip
    // sum (skip), zero where the row is not read
    unsigned in[QN / 8][2];
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int n = nc + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        in[j][h] = 0;
        if (ROLE == FIRST) continue;
        if (nc < C) {
          if (t[h] < p.n_valid)
            in[j][h] = __ldg(reinterpret_cast<const unsigned short*>(
                p.qx + row[h] + n));
        } else if (t[h] < T) {
          in[j][h] = *reinterpret_cast<const unsigned*>(p.skip + row[h] +
                                                        (n - C));
        }
      }
    }
    int prev = -1;
    for (int ks = 0; ks < C / QK; ++ks) {
      mbar_wait(&full[r.st], r.ph);
      const uint32_t s = smem_u32(ring + r.st * TL::STAGE) + cg * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QK / 32; ++kk)
        wgmma_s8_n128(acc, desc_k128(g + ks * (BM * QK) + kk * 32),
                      desc_k128(s + kk * 32), ks == 0 && kk == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = r.st;
      r.next(p.stages);
    }
    wgmma_wait<0>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);

    if (nc < C) {  // residual: x_new -> scratch, running amax
      // in two halves of the chunk: the whole chunk's values at once spill
      // at two warpgroups' 168 registers
#pragma unroll
      for (int j0 = 0; j0 < QN / 8; j0 += QN / 16) {
        float2 xv[QN / 16][2];
#pragma unroll
        for (int j = j0; j < j0 + QN / 16; ++j) {
          const int n = nc + 8 * j + 2 * q;
          const float w0 = __fmul_rn(__ldg(p.sw_rs + n), INV127);
          const float w1 = __fmul_rn(__ldg(p.sw_rs + n + 1), INV127);
          const float b0 = __ldg(p.b_rs + n), b1 = __ldg(p.b_rs + n + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x0 = 0.f, x1 = 0.f;
            if (t[h] < p.n_valid) {
              const float v0 = __fadd_rn(
                  __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), w0), b0);
              const float v1 = __fadd_rn(
                  __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), w1), b1);
              float base0, base1;
              if (ROLE == FIRST) {
                first_base(p, sX + ((rl + 8 * h) * 3 + 1) * MAX_NHALF, n,
                           base0, base1);
              } else {
                const float q0 = (float)(signed char)(in[j][h] & 0xffu);
                const float q1 = (float)(signed char)(in[j][h] >> 8);
                base0 = __fmul_rn(q0, sc[h]);
                base1 = __fmul_rn(q1, sc[h]);
              }
              x0 = __fadd_rn(base0, v0);
              x1 = __fadd_rn(base1, v1);
            }
            xv[j - j0][h] = make_float2(x0, x1);
            amax[h] = fmaxf(amax[h], fmaxf(fabsf(x0), fabsf(x1)));
          }
        }
#pragma unroll
        for (int j = j0; j < j0 + QN / 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (t[h] < T)
              *reinterpret_cast<float2*>(p.xn + row[h] + nc + 8 * j +
                                         2 * q) = xv[j - j0][h];
      }
    } else {  // skip: bf16(skip_acc + bf16(rs)) in place
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
        const int n = nc + 8 * j + 2 * q;
        const float w0 = __fmul_rn(__ldg(p.sw_rs + n), INV127);
        const float w1 = __fmul_rn(__ldg(p.sw_rs + n + 1), INV127);
        const float b0 = __ldg(p.b_rs + n), b1 = __ldg(p.b_rs + n + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (t[h] >= T) continue;
          const float v0 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), w0), b0);
          const float v1 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), w1), b1);
          __nv_bfloat162 sum;
          if (ROLE == FIRST) {
            sum = __floats2bfloat162_rn(v0, v1);
          } else {
            memcpy(&sum, &in[j][h], 4);
            sum = __floats2bfloat162_rn(
                __low2float(sum) + __bfloat162float(__float2bfloat16(v0)),
                __high2float(sum) + __bfloat162float(__float2bfloat16(v1)));
          }
          unsigned u;
          memcpy(&u, &sum, 4);
          in[j][h] = u;
        }
      }
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (t[h] < T)
            *reinterpret_cast<unsigned*>(p.skip + row[h] + nc - C + 8 * j +
                                         2 * q) = in[j][h];
    }
  }

  // every residual column is parked: each row's scale, then its payload
  // from the values this thread wrote itself
  float sq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = amax[h];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    sq[h] = m;
    if (NC == 2 && q == 0) xamax[cg * 64 + rl + 8 * h] = m;
  }
  if (NC == 2) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sq[h] = fmaxf(xamax[rl + 8 * h], xamax[64 + rl + 8 * h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] = __fmul_rn(fmaxf(sq[h], 1e-12f), INV127);
    if (cg == 0 && q == 0 && t[h] < T) p.sx_out[(size_t)b * T + t[h]] = sq[h];
  }
  for (int c0 = QN * cg; c0 < C; c0 += QN * NC) {
    float2 xv[QN / 8][2];
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[j][h] = t[h] < T ? *reinterpret_cast<const float2*>(
                                  p.xn + row[h] + c0 + 8 * j + 2 * q)
                            : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t[h] >= T) continue;
        const unsigned o0 =
            (unsigned)__float2int_rn(__fdiv_rn(xv[j][h].x, sq[h]));
        const unsigned o1 =
            (unsigned)__float2int_rn(__fdiv_rn(xv[j][h].y, sq[h]));
        *reinterpret_cast<unsigned short*>(p.qx_out + row[h] + c0 + 8 * j +
                                           2 * q) =
            (unsigned short)((o0 & 0xffu) | ((o1 & 0xffu) << 8));
      }
  }
}

// PART: the res/skip product [64, C] x [C, rs_out] in chunks of N = 128, A
// from the gated tile, the warpgroups taking alternate chunks (a group
// with no chunk left passes its stages on), and the f32 partial
// s32 * (sw_rs / 127), zero at rows t >= n_valid, written whole.  The
// chunk's column scales are loaded before its K loop.  Lanes q and q ^ 1 of
// a quad swap half of their pairs, so that an even lane holds four columns
// of row r0 and an odd lane four of row r0 + 8, and each stores them as one
// 16-byte vector (static indices only: a runtime index would move the
// accumulators, which wgmma writes asynchronously, to local memory).
template <int NC>
__device__ __forceinline__ void part_phase(const QParams& p, uint8_t* ring,
                                           uint64_t* full, uint64_t* empty,
                                           Ring& r, int cg, int tid, int b,
                                           int t0, const uint8_t* G) {
  using TL = QTile<NC>;
  const uint32_t g = smem_u32(G);
  const int lane = tid & 31, q = lane & 3;
  const bool odd = q & 1;
  const int t = t0 + (tid >> 5) * 16 + (lane >> 2) + (odd ? 8 : 0);
  const bool ok = t < p.n_valid;
  float* row = p.out + ((size_t)b * p.T + t) * p.rs_out;
  int acc[64];
  for (int n0 = 0; n0 < p.rs_out; n0 += QN * NC) {
    const int nc = n0 + QN * cg;   // this warpgroup's chunk
    if (nc >= p.rs_out) {
      pass_stages(full, empty, r, p.nrs, tid, p.stages);
      continue;
    }
    float w[QN / 8][2];
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int n = nc + 8 * j + 2 * q;
      w[j][0] = __fmul_rn(__ldg(p.sw_rs + n), INV127);
      w[j][1] = __fmul_rn(__ldg(p.sw_rs + n + 1), INV127);
    }
    int prev = -1;
    for (int ks = 0; ks < p.nrs; ++ks) {
      mbar_wait(&full[r.st], r.ph);
      const uint32_t s = smem_u32(ring + r.st * TL::STAGE) + cg * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QK / 32; ++kk)
        wgmma_s8_n128(acc, desc_k128(g + ks * (BM * QK) + kk * 32),
                      desc_k128(s + kk * 32), ks == 0 && kk == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = r.st;
      r.next(p.stages);
    }
    wgmma_wait<0>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const float a0 = __fmul_rn(__int2float_rn(acc[4 * j]), w[j][0]);
      const float a1 = __fmul_rn(__int2float_rn(acc[4 * j + 1]), w[j][1]);
      const float a2 = __fmul_rn(__int2float_rn(acc[4 * j + 2]), w[j][0]);
      const float a3 = __fmul_rn(__int2float_rn(acc[4 * j + 3]), w[j][1]);
      // send the pair the partner keeps: an even lane its row r0 + 8
      // pair, an odd lane its row r0 pair
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
      float4 v = odd ? make_float4(g0, g1, a2, a3)
                     : make_float4(a0, a1, g0, g1);
      if (!ok) v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < p.T)
        *reinterpret_cast<float4*>(row + nc + 8 * j + 2 * (q & 2)) = v;
    }
  }
}

template <int ROLE, int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    wn_int8_sm90_kernel(const __grid_constant__ QParams p) {
  using TL = QTile<NC>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ float xamax[NC == 2 ? 128 : 1];  // two column groups' row amax
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the gated tile; FINAL: the end projection's tables and `fin`
  uint8_t* G = ring + p.stages * TL::STAGE;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {  // producer warpgroup: one thread issues the loads
    if (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x == NC * 128)
      produce<ROLE, NC>(p, ring, full, empty, b, t0);
  } else {
    if (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int cg = warp >> 2, tid = threadIdx.x & 127;
    const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
    // this thread's two rows: the three taps' shifted row scales (0 outside
    // [0, n_valid), read only inside sx) and the conditioning's
    float st[3][2], ss[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int s = t + (j - 1) * p.d;
        st[j][h] = ROLE != FIRST && t < p.T && s >= 0 && s < p.n_valid
                       ? p.sx[(size_t)b * p.T + s] : 0.f;
      }
      ss[h] = t < p.T ? p.sspect[(size_t)b * p.T + t] : 0.f;
    }
    // FIRST: the block's tap rows of x0, sX [64][3][4] f32 after the gated
    // tile (0 outside [0, n_valid) and past n_half)
    float* sX = reinterpret_cast<float*>(G + (size_t)BM * p.nrs * QK);
    if (ROLE == FIRST) {
      for (int i = threadIdx.x; i < BM * 3 * MAX_NHALF; i += NC * 128) {
        const int row = i / (3 * MAX_NHALF), j = i / MAX_NHALF % 3;
        const int c = i % MAX_NHALF;
        const int t = t0 + row, s = t + (j - 1) * p.d;
        sX[i] = t < p.T && s >= 0 && s < p.n_valid && c < p.n_half
                    ? __bfloat162float(
                          p.x0[((size_t)b * p.T + s) * p.n_half + c])
                    : 0.f;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(NC * 128) : "memory");
    }
    // FINAL: the column groups' [64, 8] end projection sums, after the
    // tables
    float* fin = reinterpret_cast<float*>(G + (size_t)p.C * 4 * MAX_E);
    if (ROLE == FINAL) {
      // w_eff and w_end as [C, 8] bf16 tables, zero past E, a row of 16
      // bytes a thread (its loads all issued before the store); the sums
      // at 0
#pragma unroll 4
      for (int row = threadIdx.x; row < 2 * p.C; row += NC * 128) {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(
            row < p.C ? p.w_eff + (size_t)row * p.E
                      : p.w_end + (size_t)(row - p.C) * p.E);
        unsigned v[MAX_E];
#pragma unroll
        for (int u = 0; u < MAX_E; ++u) v[u] = u < p.E ? __ldg(src + u) : 0u;
        *reinterpret_cast<uint4*>(G + (size_t)row * 16) =
            make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                       v[4] | v[5] << 16, v[6] | v[7] << 16);
      }
      for (int i = threadIdx.x; i < NC * BM * MAX_E; i += NC * 128)
        fin[i] = 0.f;
      asm volatile("bar.sync 1, %0;\n" ::"r"(NC * 128) : "memory");
    }
    int acc[64];
    float tsum[64];
    Ring r;
    for (int c0 = 0; c0 < p.C; c0 += QH * NC) {
      const int cc = c0 + QH * cg;   // this group's gate chunk
      if (ROLE == PART && cc >= p.C) {   // no chunk of this group
        pass_stages(full, empty, r, 3 * p.ntap + p.ncond, tid, p.stages);
        continue;
      }
      inact_chunk<ROLE, NC>(p, ring, full, empty, r, cg, tid, acc, tsum, st);
      if (ROLE == FINAL)
        final_accum(p, cc, tid, b, t0, acc, tsum, ss, G,
                    fin + cg * BM * MAX_E);
      else if (ROLE == FIRST)
        gate_store_first(p, cc, tid, t0, acc, sX, ss, G);
      else
        gate_store(p, cc, tid, acc, tsum, ss, G);
    }
    if (ROLE == FINAL) {
      final_store<NC>(p, cg, tid, b, t0, fin);
      return;
    }
    // every gated column -> visible to the wgmma of both warpgroups (async
    // proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"r"(NC * 128) : "memory");
    if (ROLE == PART) {
      part_phase<NC>(p, ring, full, empty, r, cg, tid, b, t0, G);
    } else {
      const float sc[2] = {st[1][0], st[1][1]};
      rs_phase<ROLE, NC>(p, ring, full, empty, r, cg, tid, b, t0, G, xamax,
                         sc, sX);
    }
  }
}

// --- host -------------------------------------------------------------------

// the ring and the gated tile [64, C] in whole 128-column panels (FIRST:
// and the block's x0 tap rows [64][3][4] f32); FINAL: the ring, the end
// projection's two [C, 8] bf16 tables and the two column groups' [64, 8]
// f32 sums
size_t smem_bytes(int role, int nc, int C, int stages) {
  const size_t ring = 1024 + (size_t)stages * (nc * B_STAGE + A_BYTES);
  if (role == FINAL)
    return ring + (size_t)C * 2 * MAX_E * sizeof(bf16) +
           2 * BM * MAX_E * sizeof(float);
  const size_t gated = (size_t)BM * ((C + QK - 1) / QK * QK);
  if (role == FIRST) return ring + gated + BM * 3 * MAX_NHALF * sizeof(float);
  return ring + gated;
}

int encode_s8(CUtensorMap* m, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  return encode(m, ptr, rank, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

int encode_maps(QParams& p, const void* qx, const void* qspect,
                const void* qw_in, const void* qw_cond, const void* qw_rs,
                int B) {
  const cuuint64_t C = p.C, CX = p.CX, M = p.M, T = p.T;
  const cuuint64_t nv = p.n_valid > 0 ? p.n_valid : 1;
  const cuuint32_t abox[3] = {QK, BM, 1};
  const cuuint32_t wbox[2] = {QK, 64};
  int e;
  if (qx) {   // the taps (FIRST has none)
    const cuuint64_t dims[3] = {CX, nv, (cuuint64_t)B};
    const cuuint64_t str[2] = {CX, T * CX};
    if ((e = encode_s8(&p.tm_qx, qx, 3, dims, str, abox))) return e;
    const cuuint64_t wdims[2] = {CX, 6 * C};
    const cuuint64_t wstr[1] = {CX};
    if ((e = encode_s8(&p.tm_win, qw_in, 2, wdims, wstr, wbox))) return e;
  }
  {
    const cuuint64_t dims[3] = {M, T, (cuuint64_t)B};
    const cuuint64_t str[2] = {M, T * M};
    if ((e = encode_s8(&p.tm_qspect, qspect, 3, dims, str, abox))) return e;
  }
  {
    const cuuint64_t dims[2] = {M, 2 * C};
    const cuuint64_t str[1] = {M};
    if ((e = encode_s8(&p.tm_wcond, qw_cond, 2, dims, str, wbox))) return e;
  }
  if (!qw_rs) return 0;   // FINAL: no res/skip product
  // a box past C (the partial layer's Cp % 128 == 64) is zero-filled
  const cuuint64_t dims[2] = {C, (cuuint64_t)p.rs_out};
  const cuuint64_t str[1] = {C};
  return encode_s8(&p.tm_wrs, qw_rs, 2, dims, str, wbox);
}

template <int ROLE, int NC>
int launch(const QParams& p, int B, void* stream) {
  const size_t smem = smem_bytes(ROLE, NC, p.C, p.stages);
  cudaError_t e = cudaFuncSetAttribute(
      wn_int8_sm90_kernel<ROLE, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.T + BM - 1) / BM, B);
  wn_int8_sm90_kernel<ROLE, NC>
      <<<grid, (NC + 1) * 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What every role sets: widths, K stages and the tap and conditioning
// operands.
void fill_common(QParams& p, int T, int n_valid, int CX, int C, int M,
                 int d, int stages, const void* qx, const void* sx,
                 const void* sspect, const void* sw_in, const void* b_in,
                 const void* sw_cond, const void* b_cond,
                 const void* sw_rs) {
  p.T = T; p.n_valid = n_valid; p.C = C; p.CX = CX; p.M = M; p.d = d;
  p.stages = stages;
  p.ntap = n_valid > 0 ? CX / QK : 0;
  p.ncond = (M + QK - 1) / QK;
  p.nrs = (C + QK - 1) / QK;
  p.qx = (const int8_t*)qx; p.sx = (const float*)sx;
  p.sspect = (const float*)sspect;
  p.sw_in = (const float*)sw_in; p.b_in = (const float*)b_in;
  p.sw_cond = (const float*)sw_cond; p.b_cond = (const float*)b_cond;
  p.sw_rs = (const float*)sw_rs;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns 0 on success, a
// cudaError_t after the launch, or minus the CUresult of a refused tensor
// map.  `nc` (consumer warpgroups: column groups on the block's 64 rows)
// and `stages` are the launch plan of ops/wn_block_int8.py; shapes,
// dtypes, contiguity and alignment are checked there before the call.
extern "C" {

// `role`: 0 standard, 1 partial, 2 final, 3 first
size_t t2s_wn_int8_sm90_smem_bytes(int nc, int C, int stages, int role) {
  return smem_bytes(role, nc, C, stages);
}

int t2s_wn_layer_int8_sm90(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* qw_rs, const void* sw_rs, const void* b_rs, void* skip_acc,
    void* xn, void* qx_out, void* sx_out, int B, int T, int n_valid, int C,
    int M, int d, int nc, int stages, void* stream) {
  if (stages < 2 || stages > MAX_STAGES || (nc != 1 && nc != 2))
    return (int)cudaErrorInvalidValue;
  QParams p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, C, M, d, stages, qx, sx, sspect, sw_in, b_in,
              sw_cond, b_cond, sw_rs);
  p.rs_out = 2 * C;
  p.b_rs = (const float*)b_rs;
  p.skip = (bf16*)skip_acc; p.xn = (float*)xn;
  p.qx_out = (int8_t*)qx_out; p.sx_out = (float*)sx_out;
  const int e = encode_maps(p, qx, qspect, qw_in, qw_cond, qw_rs, B);
  if (e) return e;
  return nc == 2 ? launch<STD, 2>(p, B, stream)
                 : launch<STD, 1>(p, B, stream);
}

// One rank's share of an int8 layer under tensor parallelism (layers
// 1..L-1): the hidden state qx [B, T, CX] with sx, the rank's gate-paired
// columns qw_in [3, 2Cp, CX] and qw_cond [2Cp, M] with their column scales
// and b_in, b_cond [2Cp], its res/skip rows qw_rs [rs_out, Cp] with sw_rs
// [rs_out]; out [B, T, rs_out] f32 is written whole.
int t2s_wn_layer_partial_int8_sm90(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* qw_rs, const void* sw_rs, void* out, int B, int T,
    int n_valid, int CX, int Cp, int M, int rs_out, int d, int nc,
    int stages, void* stream) {
  if (stages < 2 || stages > MAX_STAGES || (nc != 1 && nc != 2))
    return (int)cudaErrorInvalidValue;
  QParams p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, CX, Cp, M, d, stages, qx, sx, sspect, sw_in,
              b_in, sw_cond, b_cond, sw_rs);
  p.rs_out = rs_out;
  p.out = (float*)out;
  const int e = encode_maps(p, qx, qspect, qw_in, qw_cond, qw_rs, B);
  if (e) return e;
  return nc == 2 ? launch<PART, 2>(p, B, stream)
                 : launch<PART, 1>(p, B, stream);
}

// The last layer of a flow with its folded end projection: the standard
// layer's taps and conditioning, w_eff and w_end [C, E] bf16, skip_acc
// [B, T, C] bf16 (read), b_eff [E]; out [B, T, E] f32.
int t2s_wn_layer_final_int8_sm90(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* w_eff, const void* skip_acc, const void* w_end,
    const void* b_eff, void* out, int B, int T, int n_valid, int C, int M,
    int E, int d, int nc, int stages, void* stream) {
  if (stages < 2 || stages > MAX_STAGES || (nc != 1 && nc != 2) || E < 1 ||
      E > MAX_E)
    return (int)cudaErrorInvalidValue;
  QParams p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, C, M, d, stages, qx, sx, sspect, sw_in, b_in,
              sw_cond, b_cond, nullptr);
  p.E = E;
  p.w_eff = (const bf16*)w_eff; p.w_end = (const bf16*)w_end;
  p.b_eff = (const float*)b_eff;
  p.skip = (bf16*)skip_acc; p.out = (float*)out;
  const int e = encode_maps(p, qx, qspect, qw_in, qw_cond, nullptr, B);
  if (e) return e;
  return nc == 2 ? launch<FINAL, 2>(p, B, stream)
                 : launch<FINAL, 1>(p, B, stream);
}

// The start projection and layer 0 of a flow: the audio half x0 [B, T,
// n_half] bf16 under the composed taps wp [3, n_half, 2C] bf16 with b_all
// and b_edge [2, 2C], the int8 conditioning and res/skip of the standard
// layer, start_k [n_half, C] bf16 and start_b [C]; writes qx_out, sx_out
// and skip_out [B, T, C] bf16, with xn the f32 scratch.
int t2s_wn_layer_first_int8_sm90(
    const void* x0, const void* qspect, const void* sspect, const void* wp,
    const void* b_all, const void* b_edge, const void* qw_cond,
    const void* sw_cond, const void* b_cond, const void* qw_rs,
    const void* sw_rs, const void* b_rs, const void* start_k,
    const void* start_b, void* xn, void* qx_out, void* sx_out,
    void* skip_out, int B, int T, int n_valid, int C, int M, int n_half,
    int d, int nc, int stages, void* stream) {
  if (stages < 2 || stages > MAX_STAGES || (nc != 1 && nc != 2) ||
      n_half < 1 || n_half > MAX_NHALF)
    return (int)cudaErrorInvalidValue;
  QParams p;
  memset(&p, 0, sizeof(p));
  fill_common(p, T, n_valid, C, C, M, d, stages, nullptr, nullptr, sspect,
              nullptr, b_all, sw_cond, b_cond, sw_rs);
  p.ntap = 0;
  p.rs_out = 2 * C;
  p.n_half = n_half;
  p.x0 = (const bf16*)x0; p.wp = (const bf16*)wp;
  p.b_edge = (const float*)b_edge;
  p.start_k = (const bf16*)start_k; p.start_b = (const float*)start_b;
  p.b_rs = (const float*)b_rs;
  p.skip = (bf16*)skip_out; p.xn = (float*)xn;
  p.qx_out = (int8_t*)qx_out; p.sx_out = (float*)sx_out;
  const int e = encode_maps(p, nullptr, qspect, nullptr, qw_cond, qw_rs, B);
  if (e) return e;
  return nc == 2 ? launch<FIRST, 2>(p, B, stream)
                 : launch<FIRST, 1>(p, B, stream);
}

}  // extern "C"
