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
// composed-conditioning vocoder) the standard layer has no spect rows:
//
//   in_act[t] = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b_in
//               + f32(cond_all[t, off : off + 2C])                 (t < T)
//
// with cond_all [B, T, cond_ld] bf16 (the folded conditioning bias already
// in it) read in place at column offset off = 2C * layer.  wn_block.cu
// keeps the first design of these roles (64-row blocks, mma.sync,
// cp.async); its entry points t2s_wn_layer, t2s_wn_layer_final and
// t2s_wn_layer_dcond stay exported so that the two designs can be timed
// side by side, and nothing else calls them.
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
// and the res/skip ring runs as in STD.
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

enum Role { STD = 0, FINAL = 1 };

struct Params {
  CUtensorMap tm_x;      // x as [B, n_valid, C]; box {32, BM, 1}, 64B swizzle
  CUtensorMap tm_spect;  // spect [B, T, M]; box {32, BM, 1}, 64B swizzle
  CUtensorMap tm_win;    // w_in as [3C, 2C]; box {64, 32}, 128B swizzle
  CUtensorMap tm_wcond;  // w_cond [M, 2C]; box {64, 32}, 128B swizzle
  CUtensorMap tm_wrs;    // STD: w_rs [C, rs_out]; box {64, 32}, 128B swizzle
  int T, n_valid, C, M, d, rs_out, E;
  int ktap;              // 3C, or 0 when n_valid == 0 (every tap reads zero)
  int stages;
  const bf16* x;         // [B, T, C]
  const bf16* cond_all;  // DCOND: [B, T, cond_ld]; the layer reads columns
  int cond_ld, cond_off; //   [cond_off, cond_off + 2C) in place
  const float* b_in;     // [2C]
  const float* b_cond;   // [2C]
  const float* b_rs;     // STD: [rs_out]
  bf16* skip;            // [B, T, C] running skip sum (STD: updated in place)
  bf16* x_out;           // STD: [B, T, C]
  const bf16* w_eff;     // FINAL: w_rs @ w_end [C, E]
  const bf16* w_end;     // FINAL: [C, E]
  const float* b_eff;    // FINAL: [E]
  float* out;            // FINAL: [B, T, E]
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
        const int j = k0 / C;
        tma_load_3d(slot + B_STAGE, &p.tm_x, k0 - j * C, t0 + (j - 1) * p.d, b,
                    bar);
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
  if (ROLE == STD) {
    // a last half chunk (rs_out = C, an odd multiple of 128) reads zeros
    // past rs_out: TMA fills them, and counts a whole box either way
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

// The in-act product of one gate-pair chunk for this warpgroup's 64 rows.
// DCOND: the chunk's conditioning is prefetched into L2 first.
template <int NWG, int BK, bool DCOND>
__device__ __forceinline__ void inact_chunk(const Params& p, uint8_t* ring,
                                            uint64_t* full, uint64_t* empty,
                                            Ring& r, int wg, int tid,
                                            float* acc, int b, int t0,
                                            int c0) {
  using TL = Tile<NWG, BK>;
  const int nk = (p.ktap + p.M + BK - 1) / BK;  // M % BK: zero fill
  if (DCOND) prefetch_cond(p, wg, tid, b, t0, c0);
  zero(acc);
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks) {
    mbar_wait(&full[r.st], r.ph);
    const uint32_t s = smem_u32(ring + r.st * TL::STAGE);
    const uint32_t a = s + TL::B_STAGE + wg * 64 * BK * 2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n256<0, 1>(acc, desc_a_ring<NWG, BK>(a + kk * 32),
                       desc_b<BK>(s + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    prev = r.st;
    r.next(p.stages);
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
}

// Gate one chunk in f32 and store it as bf16 into the gated tile.  The
// bias is b_in + b_cond, or with DCOND b_in and then the row's
// conditioning: the bf16 pairs (c, c + 1) and (C + c, C + c + 1) of
// cond_all's slice for rows t < T (the order of the plain version's sums;
// rows at or past n_valid are gated, and reach the skip sum, like any
// other, as in the first design).
template <int BM, bool DCOND>
__device__ __forceinline__ void gate_store(const Params& p, int b, int t0,
                                           int c0, int wg, int tid,
                                           const float* acc, uint8_t* G) {
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
  const int C = p.C;
  const __nv_bfloat162* crow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
    crow[h] = !DCOND || t >= p.T ? nullptr
        : reinterpret_cast<const __nv_bfloat162*>(
              p.cond_all + ((size_t)b * p.T + t) * p.cond_ld + p.cond_off +
              c0 + 2 * q);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
      __nv_bfloat162 v;
      v.x = __float2bfloat16(gate_f32(at0, as0));
      v.y = __float2bfloat16(gate_f32(at1, as1));
      *reinterpret_cast<__nv_bfloat162*>(G + gated_off<BM>(r0 + 8 * h, c)) = v;
    }
  }
}

// STD: the res/skip product in chunks of N = 256, A from the gated tile,
// with the residual and skip epilogue.
template <int NWG, int BK>
__device__ __forceinline__ void rs_phase(const Params& p, uint8_t* ring,
                                         uint64_t* full, uint64_t* empty,
                                         Ring& r, int wg, int tid, int b,
                                         int t0, const uint8_t* G) {
  constexpr int BM = NWG * 64;
  constexpr int STAGE = Tile<NWG, BK>::STAGE;
  const int C = p.C, T = p.T;
  const bool has_res = p.rs_out == 2 * C;
  const uint32_t g = smem_u32(G) + wg * 64 * 128;
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
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

    // epilogue in groups of EG column tiles: every load of a group (bias,
    // residual input, running skip) is issued before its stores, which may
    // alias them as far as the compiler knows
#pragma unroll
    for (int jg = 0; jg < GN / 8; jg += EG) {
      if (8 * jg >= nn) break;
      float bias[EG][2];
      __nv_bfloat162 in[EG][2];
#pragma unroll
      for (int jj = 0; jj < EG; ++jj) {
        const int n = n0 + 8 * (jg + jj) + 2 * q;
        bias[jj][0] = p.b_rs[n];
        bias[jj][1] = p.b_rs[n + 1];
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
      for (int jj = 0; jj < EG; ++jj) {
        const int j = jg + jj;
        const int n = n0 + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r0 + 8 * h;
          if (t >= T) continue;
          const float v0 = acc[4 * j + 2 * h] + bias[jj][0];
          const float v1 = acc[4 * j + 2 * h + 1] + bias[jj][1];
          const size_t row = ((size_t)b * T + t) * C;
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
  if (!has_res) {  // skip-only layer: the hidden state passes through
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
    float acc[128];
    Ring r;
    for (int c0 = 0; c0 < p.C; c0 += GHALF) {
      inact_chunk<NWG, BK, DCOND>(p, ring, full, empty, r, wg, tid, acc, b,
                                  t0, c0);
      gate_store<BM, DCOND>(p, b, t0, c0, wg, tid, acc, G);
    }
    // the warpgroup's gated rows -> visible to its wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (ROLE == FINAL)
      final_phase<NWG>(p, wg, tid, b, t0, G);
    else
      rs_phase<NWG, BK>(p, ring, full, empty, r, wg, tid, b, t0, G);
  }
}

// --- host -------------------------------------------------------------------

CUtensorMapSwizzle a_swizzle(int bk) {
  return bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// The tap maps: x (T extent n_valid) and w_in.
int encode_taps(Params& p, const void* x, const void* w_in, int B, int bm,
                int bk) {
  const cuuint64_t C = p.C, T = p.T;
  const cuuint64_t nv = p.n_valid > 0 ? p.n_valid : 1;
  const cuuint32_t abox[3] = {(cuuint32_t)bk, (cuuint32_t)bm, 1};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)bk};
  int e;
  {
    const cuuint64_t dims[3] = {C, nv, (cuuint64_t)B};
    const cuuint64_t str[2] = {C * 2, T * C * 2};
    if ((e = encode(&p.tm_x, x, 3, dims, str, abox, a_swizzle(bk))))
      return e;
  }
  const cuuint64_t dims[2] = {2 * C, 3 * C};
  const cuuint64_t str[1] = {2 * C * 2};
  return encode(&p.tm_win, w_in, 2, dims, str, wbox,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// The maps of the in-kernel projection: the taps', spect and w_cond.
int encode_inact(Params& p, const void* x, const void* spect, const void* w_in,
                 const void* w_cond, int B, int bm, int bk) {
  const cuuint64_t C = p.C, M = p.M, T = p.T;
  const cuuint32_t abox[3] = {(cuuint32_t)bk, (cuuint32_t)bm, 1};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)bk};
  int e;
  if ((e = encode_taps(p, x, w_in, B, bm, bk))) return e;
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

size_t stage_bytes(int nwg, int bk) {
  return (size_t)(4 * bk * 64 * 2 + nwg * 64 * bk * 2);
}

size_t smem_bytes(int nwg, int bk, int C, int stages) {
  return 1024 + (size_t)stages * stage_bytes(nwg, bk) +
         (size_t)nwg * 64 * C * 2;
}

template <int ROLE, int NWG, int BK, bool DCOND>
int launch(const Params& p, int B, void* stream) {
  const size_t smem = smem_bytes(NWG, BK, p.C, p.stages);
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

void fill_common(Params& p, int T, int n_valid, int C, int M, int d,
                 int stages, const void* x, const void* b_in,
                 const void* b_cond, const void* skip_acc) {
  p.T = T; p.n_valid = n_valid; p.C = C; p.M = M; p.d = d;
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

size_t t2s_wn_sm90_smem_bytes(int nwg, int bk, int C, int stages) {
  return smem_bytes(nwg, bk, C, stages);
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
