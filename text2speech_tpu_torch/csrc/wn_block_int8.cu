// WaveGlow WN coupling layer in int8, hand-written for Hopper (sm_90a).
//
// Four kernels, one per layer role of the quantized serving path and the
// tensor-parallel partial layer, built from one template
// (wn_layer_int8_kernel<ROLE>):
//
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block_int8.py:338
//          wn_layer_stream2_first_int8 (body _kernel_stream2_first_q, :178)
//   STD    replaces text2speech_tpu/ops/pallas/wn_block_int8.py:268
//          wn_layer_stream2_int8 (body _kernel_stream2_q, :141)
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block_int8.py:510
//          wn_layer_stream2_final_int8 (body _kernel_stream2_final_q, :220)
//   PART   replaces text2speech_tpu/ops/pallas/wn_block_int8.py:447
//          wn_layer_stream2_partial_int8 (body _kernel_stream2_partial_q,
//          :410)
//
// What one standard layer computes for rows t of one utterance.  The hidden
// state is int8 qx [T, C] with one f32 scale per row sx [T]; the grouped
// mel likewise (qspect [T, M], sspect [T]); weights are int8 with one f32
// scale per output column (sw_*), the three taps sharing one:
//
//   taps[t]   = sum_j  s32(qx[t+(j-1)d] . qw_in[j]) * sx[t+(j-1)d]      f32
//   in_act[t] = taps[t] * sw_in + b_in
//               + s32(qspect[t] . qw_cond) * sspect[t] * sw_cond + b_cond
//   q[t]      = s8( rint( tanh(in_act[t,:C]) * sigmoid(in_act[t,C:]) * 127 ))
//   rs[t]     = s32(q[t] . qw_rs) * (sw_rs / 127) + b_rs                 f32
//   x_new[t]  = t < n_valid ? qx[t] * sx[t] + rs[t,:C] : 0
//   sx_new[t] = max(amax_c |x_new[t]|, 1e-12) / 127
//   qx_new[t] = s8( rint( x_new[t] / sx_new[t] ))
//   skip[t]   = bf16(skip_acc[t] + bf16(rs[t,C:]))          (in place)
//
// Rows outside [0, n_valid) read as zero in every tap.  FIRST takes the
// rank-n_half audio half x0 (bf16) in place of qx: its taps are composed
// with the start projection once per checkpoint (K = n_half <= 4, plain
// bf16 FMAs, wn_common.cuh), only the conditioning and res/skip products
// are int8, and the residual base is x0[t] start_k + start_b.  FINAL keeps
// the gate in bf16 and emits gate w_eff + skip_acc w_end + b_eff [T, E<=8]
// in f32 (the end projection folded once per checkpoint), as the bf16
// family's final kernel does.
//
// Design.  As in wn_block.cu a block owns BM = 64 rows and gathers its halo
// rows t-d, t+d from global memory, and the in-act product runs in
// column-pair chunks (64 tanh + 64 sigmoid columns).  What int8 changes:
//
// * Every tap's s32 partial is scaled by the scale of ITS OWN shifted row
//   before the taps add, and the conditioning by sspect, so a chunk runs
//   four s32 accumulations (K = C, C, C, M), each flushed into an f32 sum
//   with its row scale (staged in shared memory once per block; 0 for a
//   halo row outside [0, n_valid), which then adds exactly 0).  They share
//   one cp.async pipeline: a flush is a register operation between stages.
// * Products are mma.sync.m16n8k32 s8 x s8 -> s32.  Its B operand wants 4
//   consecutive k of one column in a register, so the int8 weights are
//   stored output-major ([2C, K], k contiguous) and both operands load with
//   plain ldmatrix; a [K, 2C] layout would need a byte transpose on chip.
// * The gated tile is parked as s8 [BM, C] (33 KB) and is the A operand of
//   the res/skip product.
// * The requantization needs amax over all C residual columns of a row, so
//   the residual half of rs is parked as f32 and quantized per row by one
//   warp after the last chunk.  It is parked in a global scratch buffer
//   [B, T, C] that the wrapper allocates: each block re-reads only the
//   rows it wrote itself, from L2.  Parked in shared memory (130 KB at
//   C=512) it left room for one block per SM, and the kernel was no
//   faster than the bf16 one at serving batches; at 81 KB two blocks fit
//   and hide each other's barrier stalls.
// * Rounding is rint (half to even) and the quantizer divides x / s, as the
//   reference does: a reciprocal multiply would move knife-edge values.
//
// What bounds it on an H100.  The standard layer is 35.2 GOP at B=1,
// T=6400 (0.018 ms at the 1,979 TOP/s int8 peak) against 27 MB of traffic
// (0.008 ms at 3.35 TB/s): operations bound it.  Like the bf16 family each
// 64-row block streams the whole layer's weights from L2, and mma.sync
// reaches a fraction of the wgmma peak.  Larger row tiles, wgmma s8 and TMA
// are the next steps and are not done here.  Measured times are in PERF.md.
//
// The partial kernel (tensor-parallel vocoder).  One rank of p owns the
// gate-paired columns [i Cp, (i+1) Cp) u [C + i Cp, C + (i+1) Cp) of the
// taps and the conditioning (Cp = C / p), quantized with its own column
// scales, and the matching Cp rows of the res/skip weights with its own
// scales per output column.  It reads the whole int8 hidden state (CX = C
// per tap), gates its Cp column pairs to s8 at scale 127 and emits
//
//   part[t] = t < n_valid ? s32(q[t] . qw_rs) * (sw_rs / 127) : 0   [rs_out]
//
// in f32: dequantized by THIS rank's scales, so the ranks' partials are on a
// common scale when they are summed.  No bias, no residual, no skip sum and
// no requantization (the hidden state is requantized outside, after the
// sum), so the f32 scratch of the whole-layer roles is not needed.  The
// template's one width C becomes CX (the hidden state's) and C (the local
// gate width, the res/skip K); the whole-layer roles run with CX = C.  At
// p = 4 a call at B=1, T=6400 is 8.8 GOP against 35 MB, 26 MB of them the
// f32 output: bound by bytes on an H100.
//
// d, n_valid, n_half and E are runtime arguments.

#include "wn_common.cuh"

namespace {

constexpr int QK = 64;                 // int8 k (= bytes) per pipeline stage
constexpr int Q_LD = QK + 16;          // padded smem row stride, bytes
constexpr int QA_STAGE = BM * Q_LD;
constexpr int QB_STAGE = BN * Q_LD;
constexpr float INV127 = (float)(1.0 / 127.0);

enum Role { FIRST = 0, STD = 1, FINAL = 2, PART = 3 };

struct Args {
  int T, n_valid, C, M, d, n_half, E;
  int CX;                 // width of qx (the taps' K); C except in PART,
                          // where C is the rank's local gate width Cp
  int rs_out;             // PART: res/skip output columns (2 CX or CX)
  const int8_t* qx;       // STD/FINAL/PART: hidden [B,T,CX]
  const float* sx;        // STD/FINAL: row scales [B,T]
  const bf16* x0;         // FIRST: audio half [B,T,n_half]
  const int8_t* qspect;   // [B,T,M]
  const float* sspect;    // [B,T]
  const int8_t* qw_in;    // STD/FINAL/PART: [3,2C,CX] output-major
  const float* sw_in;     // STD/FINAL: [2C]
  const bf16* wp;         // FIRST: composed taps [3,n_half,2C]
  const float* b_in;      // [2C] (FIRST: b_in + folded tap bias)
  const float* b_edge;    // FIRST: [2,2C]
  const int8_t* qw_cond;  // [2C,M] output-major
  const float* sw_cond;   // [2C]
  const float* b_cond;    // [2C]
  const int8_t* qw_rs;    // FIRST/STD: [2C,C]; PART: [rs_out,C] output-major
  const float* sw_rs;     // FIRST/STD: [2C]; PART: [rs_out]
  const float* b_rs;      // FIRST/STD: [2C]
  const bf16* acc;        // STD/FINAL: running skip sum [B,T,C]
  const bf16* start_k;    // FIRST: [n_half,C]
  const float* start_b;   // FIRST: [C]
  const bf16* w_eff;      // FINAL: w_rs @ w_end [C,E]
  const bf16* w_end;      // FINAL: [C,E]
  const float* b_eff;     // FINAL: b_rs @ w_end + b_end [E]
  float* xn;              // FIRST/STD: scratch for x_new [B,T,C]
  int8_t* qx_out;         // FIRST/STD: [B,T,C]
  float* sx_out;          // FIRST/STD: [B,T]
  bf16* skip_out;         // FIRST/STD: [B,T,C]; STD aliases acc
  float* out;             // FINAL: [B,T,E]; PART: [B,T,rs_out]
};

// One pipeline stage of s8 mma: A rows wm*32 + [0, 32) of `A` (row stride
// lda bytes, already offset to the stage's first k), B rows brow0 + [0, 16)
// and brow1 + [0, 16) of the stage tile `Bs` ([n][k], stride Q_LD).
// acc[mi][ni]: rows wm*32 + mi*16; ni 0,1 = brow0 + ni*8, ni 2,3 = brow1 +
// (ni-2)*8.
__device__ __forceinline__ void mma_q_stage(const int8_t* A, int lda,
                                            const int8_t* Bs, int brow0,
                                            int brow1, int acc[2][4][4],
                                            int wm, int lane) {
#pragma unroll
  for (int kk = 0; kk < QK; kk += 32) {
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], A + (wm * 32 + mi * 16 + (lane & 15)) * lda + kk +
                              (lane >> 4) * 16);
    unsigned bfr[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned r[4];
      const int row = (h ? brow1 : brow0) + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(r, Bs + row * Q_LD + kk + ((lane >> 3) & 1) * 16);
      bfr[2 * h][0] = r[0];
      bfr[2 * h][1] = r[1];
      bfr[2 * h + 1][0] = r[2];
      bfr[2 * h + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
  }
}

// --- in-act: taps (STD/FINAL) and conditioning ---------------------------

// Stage ks covers k in [ks*QK, +QK) of the sequence tap0 | tap1 | tap2 |
// cond (KX = 3 CX tap columns; FIRST has KX = 0).
template <int ROLE>
__device__ __forceinline__ void load_inact_stage(const Args& a, int b, int t0,
                                                 int c0, int ks, int8_t* sA,
                                                 int8_t* sB) {
  const int tid = threadIdx.x;
  const int KX = (ROLE == FIRST) ? 0 : 3 * a.CX;
  const int k0 = ks * QK;
  const int tap = k0 / a.CX, kc = k0 - tap * a.CX;  // used when k0 < KX
  {  // A: BM rows x QK bytes, one 16-byte chunk per thread
    const int r = tid >> 2, seg = tid & 3;
    const int t = t0 + r;
    const int8_t* src = a.qspect;
    bool ok;
    if (k0 < KX) {
      const int s = t + (tap - 1) * a.d;
      ok = t < a.T && s >= 0 && s < a.n_valid;
      if (ok) src = a.qx + ((size_t)b * a.T + s) * a.CX + kc + seg * 16;
    } else {
      ok = t < a.T;
      if (ok)
        src = a.qspect + ((size_t)b * a.T + t) * a.M + (k0 - KX) + seg * 16;
    }
    cp_async16(sA + r * Q_LD + seg * 16, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: BN weight rows x QK bytes
    const int idx = tid + i * THREADS;
    const int r = idx >> 2, seg = idx & 3;
    const int col = r < HALF ? c0 + r : a.C + c0 + (r - HALF);
    const int8_t* src =
        k0 < KX ? a.qw_in + ((size_t)tap * 2 * a.C + col) * a.CX + kc + seg * 16
                : a.qw_cond + (size_t)col * a.M + (k0 - KX) + seg * 16;
    cp_async16(sB + r * Q_LD + seg * 16, src, true);
  }
}

// On return iacc holds the conditioning's s32 sums and tsum the three
// taps' f32 sum (each tap scaled by its shifted row's scale, sS [3][BM]).
template <int ROLE>
__device__ void inact_chunk(const Args& a, int b, int t0, int c0, int8_t* sA,
                            int8_t* sB, const float* sS, int iacc[2][4][4],
                            float tsum[2][4][4], int wm, int wn, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        iacc[mi][ni][j] = 0;
        tsum[mi][ni][j] = 0.f;
      }
  const int per_tap = a.CX / QK;
  const int nkx = (ROLE == FIRST) ? 0 : 3 * per_tap;
  const int nk = nkx + a.M / QK;
  const int g = lane >> 2;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_inact_stage<ROLE>(a, b, t0, c0, s, sA + s * QA_STAGE,
                             sB + s * QB_STAGE);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = ks + STAGES - 1;
    if (kn < nk) {
      const int sn = kn % STAGES;
      load_inact_stage<ROLE>(a, b, t0, c0, kn, sA + sn * QA_STAGE,
                             sB + sn * QB_STAGE);
    }
    cp_async_commit();
    const int st = ks % STAGES;
    mma_q_stage(sA + st * QA_STAGE, Q_LD, sB + st * QB_STAGE, wn * 16,
                HALF + wn * 16, iacc, wm, lane);
    if (ROLE != FIRST && ks < nkx && (ks + 1) % per_tap == 0) {
      // end of a tap: s32 -> f32 with the shifted row's scale (separate
      // multiply and add, as the plain version rounds)
      const float* sc = sS + (ks / per_tap) * BM;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const float s = sc[wm * 32 + mi * 16 + g + jp * 8];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = jp * 2 + e;
              tsum[mi][ni][j] = __fadd_rn(
                  tsum[mi][ni][j], __fmul_rn((float)iacc[mi][ni][j], s));
              iacc[mi][ni][j] = 0;
            }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Gate one chunk in f32 and park it in shared memory: s8 at scale 127
// (FIRST/STD, sGq stride ldq bytes) or bf16 (FINAL, sGb stride ldb).
template <int ROLE>
__device__ __forceinline__ void gate_store(
    const Args& a, int t0, int c0, const int iacc[2][4][4],
    const float tsum[2][4][4], const float* sSp, int8_t* sGq, int ldq,
    bf16* sGb, int ldb, const bf16* sX, const bf16* sW, int wm, int wn,
    int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int row = wm * 32 + mi * 16 + g + jp * 8;
        const int t = t0 + row;
        const int c = c0 + wn * 16 + ni * 8 + 2 * tq;
        const float ss = sSp[row];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jp * 2 + e;
          const int ct = c + e, cs = a.C + c + e;
          const float ct_q =
              (float)iacc[mi][ni][j] * ss * a.sw_cond[ct] + a.b_cond[ct];
          const float cs_q =
              (float)iacc[mi][ni + 2][j] * ss * a.sw_cond[cs] + a.b_cond[cs];
          float at, as;
          if (ROLE == FIRST) {
            at = a.b_in[ct];
            as = a.b_in[cs];
            if (t < a.T) {
              const int cl = wn * 16 + ni * 8 + 2 * tq + e;
              at += first_taps(sX, sW, a.b_edge, a.C, a.d, a.n_valid, row, t,
                               cl, ct);
              as += first_taps(sX, sW, a.b_edge, a.C, a.d, a.n_valid, row, t,
                               HALF + cl, cs);
            }
          } else {
            at = tsum[mi][ni][j] * a.sw_in[ct] + a.b_in[ct];
            as = tsum[mi][ni + 2][j] * a.sw_in[cs] + a.b_in[cs];
          }
          v[e] = gate_f32(at + ct_q, as + cs_q);
        }
        if (ROLE == FINAL) {
          store_bf16x2(sGb + row * ldb + c, v[0], v[1]);
        } else {
          char2 q;
          q.x = (signed char)__float2int_rn(v[0] * 127.f);
          q.y = (signed char)__float2int_rn(v[1] * 127.f);
          *reinterpret_cast<char2*>(sGq + row * ldq + c) = q;
        }
      }
}

// --- res/skip: [BM, C] s8 (smem) x [2C, C] s8, fused epilogue -----------

__device__ __forceinline__ void load_rs_stage(const Args& a, int n0, int ks,
                                              int8_t* sB) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 2, seg = idx & 3;
    cp_async16(sB + r * Q_LD + seg * 16,
               a.qw_rs + (size_t)(n0 + r) * a.C + ks * QK + seg * 16, true);
  }
}

// acc = sGq [BM, C] s8 x qw_rs[n0 : n0 + BN, :]^T in s32; every thread
// leaves past the last barrier, so the caller may reuse sB at once.
__device__ __forceinline__ void rs_mainloop(const Args& a, int n0, int8_t* sB,
                                            const int8_t* sGq, int ldq,
                                            int acc[2][4][4], int wm, int wn,
                                            int lane) {
  const int nk = a.C / QK;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_rs_stage(a, n0, s, sB + s * QB_STAGE);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = ks + STAGES - 1;
    if (kn < nk) load_rs_stage(a, n0, kn, sB + (kn % STAGES) * QB_STAGE);
    cp_async_commit();
    mma_q_stage(sGq + ks * QK, ldq, sB + (ks % STAGES) * QB_STAGE, wn * 32,
                wn * 32 + 16, acc, wm, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The partial layer's res/skip: this rank's [BM, Cp] s8 gated tile times its
// [rs_out, Cp] weight rows, dequantized by its own column scales and written
// as f32, zero at rows >= n_valid.
__device__ void rs_partial_phase(const Args& a, int b, int t0, int8_t* sB,
                                 const int8_t* sGq, int ldq, int wm, int wn,
                                 int lane) {
  const int g = lane >> 2, tq = lane & 3;
  for (int n0 = 0; n0 < a.rs_out; n0 += BN) {
    int acc[2][4][4];
    rs_mainloop(a, n0, sB, sGq, ldq, acc, wm, wn, lane);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int t = t0 + wm * 32 + mi * 16 + g + jp * 8;
          if (t >= a.T) continue;
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
          float v0 = 0.f, v1 = 0.f;
          if (t < a.n_valid) {
            v0 = (float)acc[mi][ni][jp * 2] * (a.sw_rs[n] * INV127);
            v1 = (float)acc[mi][ni][jp * 2 + 1] * (a.sw_rs[n + 1] * INV127);
          }
          *reinterpret_cast<float2*>(a.out + ((size_t)b * a.T + t) * a.rs_out +
                                     n) = make_float2(v0, v1);
        }
  }
}

// Columns [0, C) of rs are the residual: x_new = base + rs (0 at rows past
// n_valid) goes to the f32 scratch a.xn for the per-row requantization.
// Columns [C, 2C) are the skip term, added to the running sum in bf16.
template <int ROLE>
__device__ void rs_phase(const Args& a, int b, int t0, int8_t* sB,
                         const int8_t* sGq, int ldq, const float* sS, int wm,
                         int wn, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  for (int n0 = 0; n0 < 2 * a.C; n0 += BN) {
    int acc[2][4][4];
    rs_mainloop(a, n0, sB, sGq, ldq, acc, wm, wn, lane);

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = wm * 32 + mi * 16 + g + jp * 8;
          const int t = t0 + row;
          if (t >= a.T) continue;
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
          const size_t rowo = ((size_t)b * a.T + t) * a.C;
          const float v0 = (float)acc[mi][ni][jp * 2] *
                               (a.sw_rs[n] * INV127) + a.b_rs[n];
          const float v1 = (float)acc[mi][ni][jp * 2 + 1] *
                               (a.sw_rs[n + 1] * INV127) + a.b_rs[n + 1];
          if (n < a.C) {
            float r0 = 0.f, r1 = 0.f;
            if (t < a.n_valid) {
              float base0, base1;
              if (ROLE == FIRST) {
                first_base(a.x0, a.start_k, a.start_b, b, a.T, a.C, a.n_half,
                           t, n, base0, base1);
              } else {
                const char2 q =
                    *reinterpret_cast<const char2*>(a.qx + rowo + n);
                const float s = sS[BM + row];  // the centre tap's: sx[t]
                base0 = (float)q.x * s;
                base1 = (float)q.y * s;
              }
              r0 = base0 + v0;
              r1 = base1 + v1;
            }
            *reinterpret_cast<float2*>(a.xn + rowo + n) = make_float2(r0, r1);
          } else {
            const size_t o = rowo + (n - a.C);
            float s0 = bf2f(__float2bfloat16(v0));
            float s1 = bf2f(__float2bfloat16(v1));
            if (ROLE != FIRST) {
              s0 += bf2f(a.acc[o]);
              s1 += bf2f(a.acc[o + 1]);
            }
            store_bf16x2(a.skip_out + o, s0, s1);
          }
        }
  }
}

// Per-row dynamic quantization of the block's parked residual rows: one
// warp per row, amax over all C columns, scale max(amax, 1e-12) / 127, q =
// rint(x / scale).  Rows at or past n_valid were parked as 0 and store q =
// 0 with the floor scale.  The rows were written by this block before the
// barrier that precedes the call, so plain loads see them.
__device__ void requant_rows(const Args& a, int b, int t0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int row = warp * (BM / 8) + rr;
    const int t = t0 + row;
    if (t >= a.T) break;
    const float* xr = a.xn + ((size_t)b * a.T + t) * a.C;
    float amax = 0.f;
    for (int c = lane * 4; c < a.C; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(amax, 1e-12f) * INV127;
    int8_t* qo = a.qx_out + ((size_t)b * a.T + t) * a.C;
    for (int c = lane * 4; c < a.C; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      const unsigned q0 = (unsigned)__float2int_rn(v.x / s) & 0xffu;
      const unsigned q1 = (unsigned)__float2int_rn(v.y / s) & 0xffu;
      const unsigned q2 = (unsigned)__float2int_rn(v.z / s) & 0xffu;
      const unsigned q3 = (unsigned)__float2int_rn(v.w / s) & 0xffu;
      *reinterpret_cast<unsigned*>(qo + c) =
          q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
    }
    if (lane == 0) a.sx_out[(size_t)b * a.T + t] = s;
  }
}

// Shared memory, in order: A stages, B stages, row scales sS [4][BM] (three
// taps' shifted sx, then sspect), then FINAL: bf16 gated tile [BM, C+8];
// FIRST/STD/PART: s8 gated tile [BM, C+16] and FIRST's tap tables.  81 KB
// (STD) to 111 KB (FINAL) at C=512: two blocks per SM.
inline size_t smem_bytes(int role, int C) {
  size_t n = (size_t)STAGES * (QA_STAGE + QB_STAGE) + 4 * BM * sizeof(float);
  if (role == FINAL) return n + (size_t)BM * (C + 8) * sizeof(bf16);
  n += (size_t)BM * (C + 16);
  if (role == FIRST) n += (size_t)(FIRST_SX + FIRST_SW) * sizeof(bf16);
  return n;
}

template <int ROLE>
__global__ void __launch_bounds__(THREADS, 2)
    wn_layer_int8_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sB = sA + STAGES * QA_STAGE;
  float* sS = reinterpret_cast<float*>(sB + STAGES * QB_STAGE);
  unsigned char* rest = reinterpret_cast<unsigned char*>(sS + 4 * BM);
  const int ldq = a.C + 16, ldb = a.C + 8;
  bf16* sGb = reinterpret_cast<bf16*>(rest);                    // FINAL
  int8_t* sGq = reinterpret_cast<int8_t*>(rest);          // FIRST/STD/PART
  bf16* sX = reinterpret_cast<bf16*>(rest + (size_t)BM * ldq);  // FIRST
  bf16* sW = sX + FIRST_SX;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  for (int idx = threadIdx.x; idx < 4 * BM; idx += THREADS) {
    const int j = idx / BM, t = t0 + idx % BM;
    float v = 0.f;
    if (j == 3) {
      if (t < a.T) v = a.sspect[(size_t)b * a.T + t];
    } else if (ROLE != FIRST) {
      const int s = t + (j - 1) * a.d;
      if (t < a.T && s >= 0 && s < a.n_valid) v = a.sx[(size_t)b * a.T + s];
    }
    sS[idx] = v;
  }
  if (ROLE == FIRST)
    stage_first_x(a.x0, b, a.T, a.n_valid, a.d, a.n_half, t0, sX);
  __syncthreads();

  for (int c0 = 0; c0 < a.C; c0 += HALF) {
    int iacc[2][4][4];
    float tsum[2][4][4];
    if (ROLE == FIRST) {  // the previous chunk's gate_store has read sW
      __syncthreads();
      stage_first_w(a.wp, a.C, a.n_half, c0, sW);
    }
    // the mainloop's barriers publish sW before gate_store reads it
    inact_chunk<ROLE>(a, b, t0, c0, sA, sB, sS, iacc, tsum, wm, wn, lane);
    gate_store<ROLE>(a, t0, c0, iacc, tsum, sS + 3 * BM, sGq, ldq, sGb, ldb,
                     sX, sW, wm, wn, lane);
  }
  __syncthreads();
  if (ROLE == FINAL) {
    final_phase(a.acc, a.w_eff, a.w_end, a.b_eff, a.out, b, a.T, a.C, a.E, t0,
                sGb, ldb);
  } else if (ROLE == PART) {
    rs_partial_phase(a, b, t0, sB, sGq, ldq, wm, wn, lane);
  } else {
    rs_phase<ROLE>(a, b, t0, sB, sGq, ldq, sS, wm, wn, lane);
    __syncthreads();
    requant_rows(a, b, t0);
  }
}

template <int ROLE>
int launch(const Args& a, int B, void* stream) {
  const size_t smem = smem_bytes(ROLE, a.C);
  cudaError_t e = cudaFuncSetAttribute(
      wn_layer_int8_kernel<ROLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(wn_layer_int8_kernel<ROLE>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + BM - 1) / BM, B);
  wn_layer_int8_kernel<ROLE>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch: 0 on success.  Shapes, dtypes, contiguity and
// alignment are checked by the Python wrappers before the call.
extern "C" {

int t2s_wn_layer_first_int8(
    const void* x0, const void* qspect, const void* sspect, const void* wp,
    const void* b_all, const void* b_edge, const void* qw_cond,
    const void* sw_cond, const void* b_cond, const void* qw_rs,
    const void* sw_rs, const void* b_rs, const void* start_k,
    const void* start_b, void* xn, void* qx_out, void* sx_out, void* skip_out,
    int B, int T, int n_valid, int C, int M, int n_half, int d,
    void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d; a.n_half = n_half;
  a.x0 = (const bf16*)x0; a.qspect = (const int8_t*)qspect;
  a.sspect = (const float*)sspect; a.wp = (const bf16*)wp;
  a.b_in = (const float*)b_all; a.b_edge = (const float*)b_edge;
  a.qw_cond = (const int8_t*)qw_cond; a.sw_cond = (const float*)sw_cond;
  a.b_cond = (const float*)b_cond; a.qw_rs = (const int8_t*)qw_rs;
  a.sw_rs = (const float*)sw_rs; a.b_rs = (const float*)b_rs;
  a.start_k = (const bf16*)start_k; a.start_b = (const float*)start_b;
  a.xn = (float*)xn; a.qx_out = (int8_t*)qx_out; a.sx_out = (float*)sx_out;
  a.skip_out = (bf16*)skip_out;
  return launch<FIRST>(a, B, stream);
}

int t2s_wn_layer_int8(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* qw_rs, const void* sw_rs, const void* b_rs,
    const void* skip_acc, void* xn, void* qx_out, void* sx_out,
    void* skip_out, int B, int T, int n_valid, int C, int M, int d,
    void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d;
  a.qx = (const int8_t*)qx; a.sx = (const float*)sx;
  a.qspect = (const int8_t*)qspect; a.sspect = (const float*)sspect;
  a.qw_in = (const int8_t*)qw_in; a.sw_in = (const float*)sw_in;
  a.b_in = (const float*)b_in; a.qw_cond = (const int8_t*)qw_cond;
  a.sw_cond = (const float*)sw_cond; a.b_cond = (const float*)b_cond;
  a.qw_rs = (const int8_t*)qw_rs; a.sw_rs = (const float*)sw_rs;
  a.b_rs = (const float*)b_rs; a.acc = (const bf16*)skip_acc;
  a.xn = (float*)xn; a.qx_out = (int8_t*)qx_out; a.sx_out = (float*)sx_out;
  a.skip_out = (bf16*)skip_out;
  return launch<STD>(a, B, stream);
}

int t2s_wn_layer_final_int8(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* w_eff, const void* skip_acc, const void* w_end,
    const void* b_eff, void* out, int B, int T, int n_valid, int C, int M,
    int E, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d; a.E = E;
  a.qx = (const int8_t*)qx; a.sx = (const float*)sx;
  a.qspect = (const int8_t*)qspect; a.sspect = (const float*)sspect;
  a.qw_in = (const int8_t*)qw_in; a.sw_in = (const float*)sw_in;
  a.b_in = (const float*)b_in; a.qw_cond = (const int8_t*)qw_cond;
  a.sw_cond = (const float*)sw_cond; a.b_cond = (const float*)b_cond;
  a.w_eff = (const bf16*)w_eff; a.acc = (const bf16*)skip_acc;
  a.w_end = (const bf16*)w_end; a.b_eff = (const float*)b_eff;
  a.out = (float*)out;
  return launch<FINAL>(a, B, stream);
}

// The tensor-parallel partial layer: one rank's gate-paired 2 Cp columns
// (qw_in [3, 2Cp, C], qw_cond [2Cp, M], output-major, with their column
// scales) and its res/skip rows qw_rs [rs_out, Cp] with sw_rs [rs_out]; out
// [B, T, rs_out] f32 is written whole.
int t2s_wn_layer_partial_int8(
    const void* qx, const void* sx, const void* qspect, const void* sspect,
    const void* qw_in, const void* sw_in, const void* b_in,
    const void* qw_cond, const void* sw_cond, const void* b_cond,
    const void* qw_rs, const void* sw_rs, void* out, int B, int T,
    int n_valid, int C, int Cp, int M, int rs_out, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = Cp; a.CX = C; a.M = M; a.d = d;
  a.rs_out = rs_out;
  a.qx = (const int8_t*)qx; a.sx = (const float*)sx;
  a.qspect = (const int8_t*)qspect; a.sspect = (const float*)sspect;
  a.qw_in = (const int8_t*)qw_in; a.sw_in = (const float*)sw_in;
  a.b_in = (const float*)b_in; a.qw_cond = (const int8_t*)qw_cond;
  a.sw_cond = (const float*)sw_cond; a.b_cond = (const float*)b_cond;
  a.qw_rs = (const int8_t*)qw_rs; a.sw_rs = (const float*)sw_rs;
  a.out = (float*)out;
  return launch<PART>(a, B, stream);
}

}  // extern "C"
