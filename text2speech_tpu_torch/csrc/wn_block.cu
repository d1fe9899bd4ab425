// WaveGlow WN coupling layer, hand-written for Hopper (sm_90a).
//
// Eight kernels: one per layer role of the fused serving path and per
// source of the conditioning, and the tensor-parallel partial layer in its
// two forms, all built from one template (wn_layer_kernel<ROLE, DCOND>).
// With DCOND = false the conditioning is projected in the kernel
// (spect[t] Wc + b_cond):
//
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block.py:459
//          wn_layer_stream2_first (body _kernel_stream2_first, :281)
//   STD    replaces text2speech_tpu/ops/pallas/wn_block.py:398
//          wn_layer_stream2 (body _kernel_stream2, :200)
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block.py:528
//          wn_layer_stream2_final (body _kernel_stream2_final, :325)
//
//   PART, PART_FIRST  replace text2speech_tpu/ops/pallas/wn_block.py:642
//          wn_layer_stream2_partial (body _kernel_stream2_partial, :612),
//          without and with the layer-0 edge-bias rows
//
// With DCOND = true (the composed-conditioning vocoder) it is read from a
// column slice of a pre-materialised cond_all [B, T, cond_ld] (bf16, the
// folded bias already in it), widened to f32 and added in the gate
// epilogue; the same bodies with project_cond=False on the TPU:
//
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:100
//          wn_layer_stream2_first_dcond
//   STD    replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:43
//          wn_layer_stream2_dcond
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block_dcond.py:162
//          wn_layer_stream2_final_dcond
//
// What one layer computes, for rows t of one utterance (hidden x [T, C],
// grouped mel spect [T, M], dilation d, valid length n_valid):
//
//   in_act[t] = x[t-d] W0 + x[t] W1 + x[t+d] W2 + spect[t] Wc + b   [2C], f32
//   acts[t]   = bf16( tanh(in_act[t, :C]) * sigmoid(in_act[t, C:]) )
//   rs[t]     = acts[t] W_rs + b_rs                                   f32
//   x_out[t]  = t < n_valid ? bf16(x[t] + rs[t, :C]) : 0
//   skip[t]   = bf16(skip_acc[t] + bf16(rs[t, C:]))
//
// x rows outside [0, n_valid) read as zero (the conv's zero padding at the
// true length), so nothing past n_valid reaches a valid row.  FIRST takes
// the rank-n_half audio half x0 in place of x: the start projection is
// composed onto its taps once per checkpoint (K = n_half <= 4, plain FMAs) and
// the residual base is x0[t] start_k + start_b, computed here.  FINAL
// emits acts W_rs' + skip_acc W_end + b' with W_rs' = W_rs W_end [C, E<=8]
// folded once per checkpoint: the (b, log_s) coupling terms in f32.
//
// Design.  The TPU kernels walk T in order and carry the previous tile in
// a two-slot VMEM ring for the left halo.  CUDA blocks run in no order, so
// here a block owns BM = 64 rows of one utterance and reads its own halo
// rows t-d and t+d straight from global memory (zero outside
// [0, n_valid)).  The three taps and the conditioning then form ONE GEMM
// with K = 3C + M (2176 at C=512, M=640) over a gathered A operand; no
// [BM + 2d, C] window is staged (at d=128 it would not fit in shared
// memory).  The gate pairs column c with c + C, so the in-act GEMM runs in
// column-pair chunks [c0, c0+64) u [C+c0, C+c0+64): each chunk is gated in
// f32 in registers and stored as bf16 into a [BM, C] tile in shared memory
// (65 KB at C=512).  The res/skip GEMM [BM, C] x [C, rs_out] then reads its
// A operand from that tile, with the residual and skip epilogue fused.
// Matrix products are bf16 mma.sync.m16n8k16 with f32 accumulation, fed by
// ldmatrix from a 3-stage cp.async pipeline.  The block shape and the
// helpers shared with the int8 family (wn_block_int8.cu) are in
// wn_common.cuh.
//
// What bounds it on an H100.  Every block streams the whole layer's
// weights: w_in (3 MB) + w_cond (1.3 MB) + w_rs (1 MB) per 64 rows, from L2
// after the first block: 64 FLOP per weight byte read.  With 64-row blocks
// and mma.sync the kernel is bound by that L2 stream and by mma.sync
// throughput, far from the 989 TFLOP/s bf16 (wgmma) peak: the standard
// layer measured 0.39 ms at B=1, T=6400 (~90 TFLOP/s) and 0.93 ms at B=3
// (113 TFLOP/s) on "NVIDIA H100 80GB HBM3, 700.00 W".  wn_block_sm90.cu
// redesigns STD and FINAL (DCOND = false) with larger row blocks, wgmma and
// TMA, and ops/wn_block.py launches that; the two instantiations here stay
// as the first design, which only chip_smoke.py times beside it.
//
// The DCOND kernels.  The in-act GEMM loses its M conditioning rows: K = 3C
// (1536 of 2176 at C=512, M=640), and FIRST has no GEMM before the gate at
// all (its taps are FMAs).  In their place each thread reads the two bf16
// pairs of cond_all that belong to its accumulator pair, at row stride
// cond_ld and column offset cond_off (both runtime arguments, so a layer
// reads its slice in place: no copy of a slice is ever made).  That is
// 2C bf16 per row, 13 MB per call at T=6400: far below the weights' L2
// stream, so the kernel stays bound by operations.
//
// The partial kernels (tensor-parallel vocoder).  One rank of p owns the
// gate-paired columns [i Cp, (i+1) Cp) u [C + i Cp, C + (i+1) Cp) of the
// in-act product (Cp = C / p) and the matching Cp rows of the res/skip
// product.  Its kernel reads the whole hidden state (K = CX = C per tap, or
// the rank-n_half audio half with the composed taps and the edge-bias rows:
// PART_FIRST), gates its Cp column pairs into a [BM, Cp] tile and multiplies
// that by its [Cp, rs_out] rows.  The result is WRITTEN as f32 [B, T,
// rs_out], zero at rows >= n_valid, with no res/skip bias, residual or skip
// sum: those need the sum over ranks and are added once, outside.  So the
// template's one width C becomes two: CX (the hidden state's, the taps' K)
// and C (the local gate width, the res/skip K); the whole-layer roles run
// with CX = C.  Per rank the products shrink by p but x and spect are read
// whole and rs_out f32 columns are written: at p = 4 (Cp = 128) a call at
// B=1, T=6400 is 8.8 GFLOP against 41 MB, 26 MB of them the f32 output, so
// on an H100 the partial layer is bound by bytes where the whole layer is
// bound by operations.  Measured times are in PERF.md.
//
// d, n_valid, n_half, E and the cond_all slice are runtime arguments: no
// kernel is specialised per utterance length, per flow or per layer.

#include "wn_common.cuh"

namespace {

constexpr int BK = 32;           // k per pipeline stage
constexpr int A_LD = BK + 8;     // padded smem strides (bf16 elements):
constexpr int B_LD = BN + 8;     // ldmatrix rows land in distinct banks
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;

enum Role { FIRST = 0, STD = 1, FINAL = 2, PART = 3, PART_FIRST = 4 };

// Roles whose taps are the rank-n_half composed taps (plain FMAs).
__host__ __device__ constexpr bool first_taps_role(int role) {
  return role == FIRST || role == PART_FIRST;
}

struct Args {
  int T, n_valid, C, M, d, n_half, E, rs_out;
  int CX;                // width of x (the taps' K); C except in PART, where
                         // C is the rank's local gate width Cp
  const bf16* x;         // STD/FINAL/PART: hidden [B,T,CX]; FIRST and
                         // PART_FIRST: x0 [B,T,n_half]
  const bf16* spect;     // [B,T,M] (not DCOND)
  const bf16* cond_all;  // DCOND: [B,T,cond_ld]; columns [cond_off, +2C) used
  int cond_ld, cond_off;
  const bf16* w_in;      // STD/FINAL: [3,C,2C]; FIRST: composed wp [3,n_half,2C]
  const float* b_in;     // [2C] (FIRST: b_in + folded tap bias)
  const float* b_edge;   // FIRST: [2,2C] left/right folded-bias corrections
  const bf16* w_cond;    // [M,2C] (not DCOND)
  const float* b_cond;   // [2C] (not DCOND)
  const bf16* w_rs;      // STD/FIRST: [C,rs_out]; FINAL: w_rs@w_end [C,E]
  const float* b_rs;     // STD/FIRST: [rs_out]
  const bf16* acc;       // STD/FINAL: running skip sum [B,T,C]
  const bf16* start_k;   // FIRST: [n_half,C]
  const float* start_b;  // FIRST: [C]
  const bf16* w_end;     // FINAL: [C,E]
  const float* b_end;    // FINAL: [E] (= b_rs@w_end + b_end)
  bf16* x_out;           // STD/FIRST: [B,T,C]
  bf16* skip_out;        // STD/FIRST: [B,T,C]; STD may alias acc
  float* out;            // FINAL: [B,T,E]; PART/PART_FIRST: [B,T,rs_out]
};

// --- in-act GEMM: [BM, K] x [K, 64 tanh + 64 sigmoid cols] ---------------

// K rows of the combined weight: [0, KX) are the three taps of w_in
// (STD/FINAL/PART; KX = 3 CX), [KX, KX + M) are w_cond (absent with DCOND).
// FIRST and PART_FIRST have KX = 0: their taps are rank n_half and added by
// FMA in the gate epilogue.
template <int ROLE>
__device__ __forceinline__ void load_inact_stage(const Args& a, int b, int t0,
                                                 int c0, int ks, bf16* sA,
                                                 bf16* sB) {
  const int tid = threadIdx.x;
  const int C2 = 2 * a.C;
  const int KX = first_taps_role(ROLE) ? 0 : 3 * a.CX;
  const int k0 = ks * BK;
  {  // A: BM rows x BK bf16, one 16-byte chunk per thread
    const int r = tid >> 2, seg = tid & 3;
    const int t = t0 + r;
    const bf16* src = a.spect;
    bool ok;
    if (k0 < KX) {
      const int tap = k0 / a.CX, kc = k0 - tap * a.CX;
      const int s = t + (tap - 1) * a.d;
      ok = t < a.T && s >= 0 && s < a.n_valid;
      if (ok) src = a.x + ((size_t)b * a.T + s) * a.CX + kc + seg * 8;
    } else {
      ok = t < a.T;
      if (ok) src = a.spect + ((size_t)b * a.T + t) * a.M + (k0 - KX) + seg * 8;
    }
    cp_async16(sA + r * A_LD + seg * 8, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: BK rows x BN bf16, two chunks a thread
    const int idx = tid + i * THREADS;
    const int r = idx >> 4, seg = idx & 15;
    const int k = k0 + r;
    const int col = seg < 8 ? c0 + seg * 8 : a.C + c0 + (seg - 8) * 8;
    const bf16* row = k < KX ? a.w_in + (size_t)k * C2
                             : a.w_cond + (size_t)(k - KX) * C2;
    cp_async16(sB + r * B_LD + seg * 8, row + col, true);
  }
}

// acc[mi][ni]: warp rows wm*32 + mi*16; ni 0,1 = tanh cols wn*16 + ni*8,
// ni 2,3 = the matching sigmoid cols (64 + wn*16 + (ni-2)*8 in the tile).
__device__ __forceinline__ void mma_inact_stage(const bf16* sA,
                                                const bf16* sB,
                                                float acc[2][4][4], int wm,
                                                int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], sA + (wm * 32 + mi * 16 + (lane & 15)) * A_LD + kk +
                              (lane >> 4) * 8);
    unsigned bfr[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned r[4];
      ldmatrix_x4_trans(r, sB + (kk + (lane & 15)) * B_LD + h * HALF +
                               wn * 16 + (lane >> 4) * 8);
      bfr[2 * h][0] = r[0];
      bfr[2 * h][1] = r[1];
      bfr[2 * h + 1][0] = r[2];
      bfr[2 * h + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
  }
}

template <int ROLE, bool DCOND>
__device__ void inact_chunk(const Args& a, int b, int t0, int c0, bf16* sA,
                            bf16* sB, float acc[2][4][4], int wm, int wn,
                            int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  const int nk =
      ((first_taps_role(ROLE) ? 0 : 3 * a.CX) + (DCOND ? 0 : a.M)) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_inact_stage<ROLE>(a, b, t0, c0, s, sA + s * A_STAGE,
                             sB + s * B_STAGE);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = ks + STAGES - 1;
    if (kn < nk) {
      const int sn = kn % STAGES;
      load_inact_stage<ROLE>(a, b, t0, c0, kn, sA + sn * A_STAGE,
                             sB + sn * B_STAGE);
    }
    cp_async_commit();
    const int st = ks % STAGES;
    mma_inact_stage(sA + st * A_STAGE, sB + st * B_STAGE, acc, wm, wn, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Gate one chunk in f32 and store it as bf16 into the [BM, C] smem tile.
// DCOND: the conditioning of columns (c, c + 1) and (C + c, C + c + 1) of
// row t comes from cond_all as two bf16 pairs, in place of b_cond.
template <int ROLE, bool DCOND>
__device__ __forceinline__ void gate_store(const Args& a, int b, int t0,
                                           int c0, const float acc[2][4][4],
                                           bf16* sG, int G_LD, const bf16* sX,
                                           const bf16* sW, int wm, int wn,
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
        float v[2];
        float cd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [tanh, sigmoid][e]
        if (DCOND) {
          if (t < a.T) {
            const bf16* cr = a.cond_all +
                             ((size_t)b * a.T + t) * a.cond_ld + a.cond_off + c;
            const __nv_bfloat162 vt =
                *reinterpret_cast<const __nv_bfloat162*>(cr);
            const __nv_bfloat162 vs =
                *reinterpret_cast<const __nv_bfloat162*>(cr + a.C);
            cd[0][0] = __low2float(vt);
            cd[0][1] = __high2float(vt);
            cd[1][0] = __low2float(vs);
            cd[1][1] = __high2float(vs);
          }
        } else {
          cd[0][0] = a.b_cond[c];
          cd[0][1] = a.b_cond[c + 1];
          cd[1][0] = a.b_cond[a.C + c];
          cd[1][1] = a.b_cond[a.C + c + 1];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ct = c + e, cs = a.C + c + e;
          float at = acc[mi][ni][jp * 2 + e] + a.b_in[ct] + cd[0][e];
          float as = acc[mi][ni + 2][jp * 2 + e] + a.b_in[cs] + cd[1][e];
          if (first_taps_role(ROLE) && t < a.T) {
            const int cl = wn * 16 + ni * 8 + 2 * tq + e;
            at += first_taps(sX, sW, a.b_edge, a.C, a.d, a.n_valid, row, t,
                             cl, ct);
            as += first_taps(sX, sW, a.b_edge, a.C, a.d, a.n_valid, row, t,
                             HALF + cl, cs);
          }
          v[e] = gate_f32(at, as);
        }
        store_bf16x2(sG + row * G_LD + c, v[0], v[1]);
      }
}

// --- res/skip GEMM: [BM, C] (smem) x [C, rs_out], fused epilogue --------

__device__ __forceinline__ void load_rs_stage(const Args& a, int n0, int ks,
                                              bf16* sB) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 4, seg = idx & 15;
    const int k = ks * BK + r;
    cp_async16(sB + r * B_LD + seg * 8,
               a.w_rs + (size_t)k * a.rs_out + n0 + seg * 8, true);
  }
}

// acc = sG [BM, C] x w_rs[:, n0 : n0 + BN]; every thread leaves past the
// last barrier, so the caller may reuse sB at once.
__device__ __forceinline__ void rs_mainloop(const Args& a, int n0, bf16* sB,
                                            const bf16* sG, int G_LD,
                                            float acc[2][4][4], int wm,
                                            int wn, int lane) {
  const int nk = a.C / BK;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_rs_stage(a, n0, s, sB + s * B_STAGE);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = ks + STAGES - 1;
    if (kn < nk) load_rs_stage(a, n0, kn, sB + (kn % STAGES) * B_STAGE);
    cp_async_commit();
    const bf16* Bs = sB + (ks % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], sG + (wm * 32 + mi * 16 + (lane & 15)) * G_LD +
                                ks * BK + kk + (lane >> 4) * 8);
      unsigned bfr[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 15)) * B_LD + wn * 32 +
                                 h * 16 + (lane >> 4) * 8);
        bfr[2 * h][0] = r[0];
        bfr[2 * h][1] = r[1];
        bfr[2 * h + 1][0] = r[2];
        bfr[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The partial layer's res/skip: this rank's [BM, Cp] gated tile times its
// [Cp, rs_out] rows, written as f32 and zero at rows >= n_valid.  No bias,
// residual or skip sum: they follow the sum over ranks.
__device__ void rs_partial_phase(const Args& a, int b, int t0, bf16* sB,
                                 const bf16* sG, int G_LD, int wm, int wn,
                                 int lane) {
  const int g = lane >> 2, tq = lane & 3;
  for (int n0 = 0; n0 < a.rs_out; n0 += BN) {
    float acc[2][4][4];
    rs_mainloop(a, n0, sB, sG, G_LD, acc, wm, wn, lane);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int t = t0 + wm * 32 + mi * 16 + g + jp * 8;
          if (t >= a.T) continue;
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
          const bool valid = t < a.n_valid;
          *reinterpret_cast<float2*>(a.out + ((size_t)b * a.T + t) * a.rs_out +
                                     n) =
              make_float2(valid ? acc[mi][ni][jp * 2] : 0.f,
                          valid ? acc[mi][ni][jp * 2 + 1] : 0.f);
        }
  }
}

template <int ROLE>
__device__ void rs_phase(const Args& a, int b, int t0, bf16* sB,
                         const bf16* sG, int G_LD, int wm, int wn, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const bool has_res = a.rs_out == 2 * a.C;
  for (int n0 = 0; n0 < a.rs_out; n0 += BN) {
    float acc[2][4][4];
    rs_mainloop(a, n0, sB, sG, G_LD, acc, wm, wn, lane);

    // epilogue: residual (masked past n_valid) and skip accumulation
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int t = t0 + wm * 32 + mi * 16 + g + jp * 8;
          if (t >= a.T) continue;
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
          const float v0 = acc[mi][ni][jp * 2] + a.b_rs[n];
          const float v1 = acc[mi][ni][jp * 2 + 1] + a.b_rs[n + 1];
          const size_t rowo = ((size_t)b * a.T + t) * a.C;
          if (has_res && n < a.C) {
            float r0 = 0.f, r1 = 0.f;
            if (t < a.n_valid) {
              float base0, base1;
              if (ROLE == FIRST) {  // xh = x0[t] @ start_k + start_b
                first_base(a.x, a.start_k, a.start_b, b, a.T, a.C, a.n_half,
                           t, n, base0, base1);
              } else {
                base0 = bf2f(a.x[rowo + n]);
                base1 = bf2f(a.x[rowo + n + 1]);
              }
              r0 = base0 + v0;
              r1 = base1 + v1;
            }
            store_bf16x2(a.x_out + rowo + n, r0, r1);
          } else {
            const int cs = has_res ? n - a.C : n;
            float s0 = bf2f(__float2bfloat16(v0));
            float s1 = bf2f(__float2bfloat16(v1));
            if (ROLE != FIRST) {
              s0 += bf2f(a.acc[rowo + cs]);
              s1 += bf2f(a.acc[rowo + cs + 1]);
            }
            store_bf16x2(a.skip_out + rowo + cs, s0, s1);
          }
        }
  }
  if (!has_res) {  // skip-only layer: the hidden state passes through
    for (int i = threadIdx.x; i < BM * a.C; i += THREADS) {
      const int t = t0 + i / a.C, c = i % a.C;
      if (t >= a.T) break;
      const size_t o = ((size_t)b * a.T + t) * a.C + c;
      a.x_out[o] = t < a.n_valid ? a.x[o] : __float2bfloat16(0.f);
    }
  }
}

template <int ROLE, bool DCOND>
__global__ void __launch_bounds__(THREADS) wn_layer_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * A_STAGE;
  bf16* sG = sB + STAGES * B_STAGE;
  const int G_LD = a.C + 8;
  bf16* sX = sG + BM * G_LD;  // FIRST and PART_FIRST only
  bf16* sW = sX + FIRST_SX;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  if (first_taps_role(ROLE))
    stage_first_x(a.x, b, a.T, a.n_valid, a.d, a.n_half, t0, sX);
  for (int c0 = 0; c0 < a.C; c0 += HALF) {
    float acc[2][4][4];
    if (first_taps_role(ROLE)) {  // the previous chunk's gate_store has read sW
      __syncthreads();
      stage_first_w(a.w_in, a.C, a.n_half, c0, sW);
    }
    // the mainloop's barriers publish sX/sW before gate_store reads them
    inact_chunk<ROLE, DCOND>(a, b, t0, c0, sA, sB, acc, wm, wn, lane);
    gate_store<ROLE, DCOND>(a, b, t0, c0, acc, sG, G_LD, sX, sW, wm, wn,
                            lane);
  }
  __syncthreads();
  if (ROLE == FINAL)
    final_phase(a.acc, a.w_rs, a.w_end, a.b_end, a.out, b, a.T, a.C, a.E, t0,
                sG, G_LD);
  else if (ROLE == PART || ROLE == PART_FIRST)
    rs_partial_phase(a, b, t0, sB, sG, G_LD, wm, wn, lane);
  else
    rs_phase<ROLE>(a, b, t0, sB, sG, G_LD, wm, wn, lane);
}

template <int ROLE, bool DCOND = false>
int launch(const Args& a, int B, void* stream) {
  const size_t smem =
      (size_t)(STAGES * (A_STAGE + B_STAGE) + BM * (a.C + 8) +
               (first_taps_role(ROLE) ? FIRST_SX + FIRST_SW : 0)) *
      sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      wn_layer_kernel<ROLE, DCOND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + BM - 1) / BM, B);
  wn_layer_kernel<ROLE, DCOND>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch: 0 on success.  Shapes, dtypes, contiguity and
// alignment are checked by the Python wrappers before the call.
extern "C" {

int t2s_wn_layer_first(const void* x0, const void* spect, const void* wp,
                       const void* b_all, const void* b_edge,
                       const void* w_cond, const void* b_cond,
                       const void* w_rs, const void* b_rs,
                       const void* start_k, const void* start_b, void* x_out,
                       void* skip_out, int B, int T, int n_valid, int C,
                       int M, int n_half, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d;
  a.n_half = n_half; a.rs_out = 2 * C;
  a.x = (const bf16*)x0; a.spect = (const bf16*)spect;
  a.w_in = (const bf16*)wp; a.b_in = (const float*)b_all;
  a.b_edge = (const float*)b_edge; a.w_cond = (const bf16*)w_cond;
  a.b_cond = (const float*)b_cond; a.w_rs = (const bf16*)w_rs;
  a.b_rs = (const float*)b_rs; a.start_k = (const bf16*)start_k;
  a.start_b = (const float*)start_b; a.x_out = (bf16*)x_out;
  a.skip_out = (bf16*)skip_out;
  return launch<FIRST>(a, B, stream);
}

int t2s_wn_layer(const void* x, const void* spect, const void* w_in,
                 const void* b_in, const void* w_cond, const void* b_cond,
                 const void* w_rs, const void* b_rs, const void* skip_acc,
                 void* x_out, void* skip_out, int B, int T, int n_valid,
                 int C, int M, int rs_out, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d;
  a.rs_out = rs_out;
  a.x = (const bf16*)x; a.spect = (const bf16*)spect;
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.w_cond = (const bf16*)w_cond; a.b_cond = (const float*)b_cond;
  a.w_rs = (const bf16*)w_rs; a.b_rs = (const float*)b_rs;
  a.acc = (const bf16*)skip_acc; a.x_out = (bf16*)x_out;
  a.skip_out = (bf16*)skip_out;
  return launch<STD>(a, B, stream);
}

int t2s_wn_layer_final(const void* x, const void* spect, const void* w_in,
                       const void* b_in, const void* w_cond,
                       const void* b_cond, const void* w_rs_end,
                       const void* skip_acc, const void* w_end,
                       const void* b_end, void* out, int B, int T,
                       int n_valid, int C, int M, int E, int d,
                       void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.M = M; a.d = d; a.E = E;
  a.x = (const bf16*)x; a.spect = (const bf16*)spect;
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.w_cond = (const bf16*)w_cond; a.b_cond = (const float*)b_cond;
  a.w_rs = (const bf16*)w_rs_end; a.acc = (const bf16*)skip_acc;
  a.w_end = (const bf16*)w_end; a.b_end = (const float*)b_end;
  a.out = (float*)out;
  return launch<FINAL>(a, B, stream);
}

// The tensor-parallel partial layer: one rank's gate-paired 2 Cp columns of
// w_in [3, K, 2Cp] / w_cond [M, 2Cp] and its rows w_rs [Cp, rs_out]; out
// [B, T, rs_out] f32 is written whole.  b_edge == NULL: x is the hidden
// state [B, T, K = C]; otherwise x is the audio half [B, T, K = n_half <= 4]
// under the composed taps and b_edge [2, 2Cp] is taken back at the edges.
int t2s_wn_layer_partial(const void* x, const void* spect, const void* w_in,
                         const void* b_in, const void* b_edge,
                         const void* w_cond, const void* b_cond,
                         const void* w_rs, void* out, int B, int T,
                         int n_valid, int K, int Cp, int M, int rs_out, int d,
                         void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = Cp; a.M = M; a.d = d;
  a.rs_out = rs_out;
  a.x = (const bf16*)x; a.spect = (const bf16*)spect;
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.b_edge = (const float*)b_edge; a.w_cond = (const bf16*)w_cond;
  a.b_cond = (const float*)b_cond; a.w_rs = (const bf16*)w_rs;
  a.out = (float*)out;
  if (b_edge) {
    a.n_half = K;
    return launch<PART_FIRST>(a, B, stream);
  }
  a.CX = K;
  return launch<PART>(a, B, stream);
}

// The composed-conditioning family: cond_all [B, T, cond_ld] bf16 in place
// of spect, w_cond and b_cond; the layer reads columns [cond_off, +2C).

int t2s_wn_layer_first_dcond(const void* x0, const void* cond_all,
                             const void* wp, const void* b_all,
                             const void* b_edge, const void* w_rs,
                             const void* b_rs, const void* start_k,
                             const void* start_b, void* x_out, void* skip_out,
                             int B, int T, int n_valid, int C, int cond_ld,
                             int cond_off, int n_half, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.d = d;
  a.n_half = n_half; a.rs_out = 2 * C;
  a.x = (const bf16*)x0; a.cond_all = (const bf16*)cond_all;
  a.cond_ld = cond_ld; a.cond_off = cond_off;
  a.spect = a.cond_all;  // a valid address for the zero-size halo copies
  a.w_in = (const bf16*)wp; a.b_in = (const float*)b_all;
  a.b_edge = (const float*)b_edge; a.w_rs = (const bf16*)w_rs;
  a.b_rs = (const float*)b_rs; a.start_k = (const bf16*)start_k;
  a.start_b = (const float*)start_b; a.x_out = (bf16*)x_out;
  a.skip_out = (bf16*)skip_out;
  return launch<FIRST, true>(a, B, stream);
}

int t2s_wn_layer_dcond(const void* x, const void* cond_all, const void* w_in,
                       const void* b_in, const void* w_rs, const void* b_rs,
                       const void* skip_acc, void* x_out, void* skip_out,
                       int B, int T, int n_valid, int C, int cond_ld,
                       int cond_off, int rs_out, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.d = d; a.rs_out = rs_out;
  a.x = (const bf16*)x; a.cond_all = (const bf16*)cond_all;
  a.cond_ld = cond_ld; a.cond_off = cond_off;
  a.spect = a.cond_all;  // a valid address for the zero-size halo copies
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.w_rs = (const bf16*)w_rs; a.b_rs = (const float*)b_rs;
  a.acc = (const bf16*)skip_acc; a.x_out = (bf16*)x_out;
  a.skip_out = (bf16*)skip_out;
  return launch<STD, true>(a, B, stream);
}

int t2s_wn_layer_final_dcond(const void* x, const void* cond_all,
                             const void* w_in, const void* b_in,
                             const void* w_rs_end, const void* skip_acc,
                             const void* w_end, const void* b_end, void* out,
                             int B, int T, int n_valid, int C, int cond_ld,
                             int cond_off, int E, int d, void* stream) {
  Args a = {};
  a.T = T; a.n_valid = n_valid; a.C = C; a.CX = C; a.d = d; a.E = E;
  a.x = (const bf16*)x; a.cond_all = (const bf16*)cond_all;
  a.cond_ld = cond_ld; a.cond_off = cond_off;
  a.spect = a.cond_all;  // a valid address for the zero-size halo copies
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.w_rs = (const bf16*)w_rs_end; a.acc = (const bf16*)skip_acc;
  a.w_end = (const bf16*)w_end; a.b_end = (const float*)b_end;
  a.out = (float*)out;
  return launch<FINAL, true>(a, B, stream);
}

}  // extern "C"
