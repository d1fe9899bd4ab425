// WaveGlow WN coupling layer, hand-written for Hopper (sm_90a).
//
// Three kernels, one per layer role of the fused serving path, all built
// from one template (wn_layer_kernel<ROLE>):
//
//   FIRST  replaces text2speech_tpu/ops/pallas/wn_block.py:459
//          wn_layer_stream2_first (body _kernel_stream2_first, :281)
//   STD    replaces text2speech_tpu/ops/pallas/wn_block.py:398
//          wn_layer_stream2 (body _kernel_stream2, :200)
//   FINAL  replaces text2speech_tpu/ops/pallas/wn_block.py:528
//          wn_layer_stream2_final (body _kernel_stream2_final, :325)
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
// composed onto its taps by the wrapper (K = n_half <= 4, plain FMAs) and
// the residual base is x0[t] start_k + start_b, computed here.  FINAL
// emits acts W_rs' + skip_acc W_end + b' with W_rs' = W_rs W_end [C, E<=8]
// folded by the wrapper: the (b, log_s) coupling terms in f32.
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
// ldmatrix from a 3-stage cp.async pipeline.
//
// What bounds it on an H100.  Every block streams the whole layer's
// weights: w_in (3 MB) + w_cond (1.3 MB) + w_rs (1 MB) per 64 rows, from L2
// after the first block: 64 FLOP per weight byte read.  With 64-row blocks
// and mma.sync the kernel is bound by that L2 stream and by mma.sync
// throughput, far from the 989 TFLOP/s bf16 (wgmma) peak: the standard
// layer measured 0.39 ms at B=1, T=6400 (~90 TFLOP/s) and 0.93 ms at B=3
// (113 TFLOP/s) on "NVIDIA H100 80GB HBM3, 700.00 W".  Larger row blocks,
// wgmma and TMA multicast of the weight tiles across a cluster are the
// next steps, and are not done here.
//
// d, n_valid, n_half and E are runtime arguments: no kernel is specialised
// per utterance length or per flow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;           // rows per block
constexpr int BK = 32;           // k per pipeline stage
constexpr int HALF = 64;         // gate-pair chunk: 64 tanh + 64 sigmoid cols
constexpr int BN = 2 * HALF;     // columns per GEMM chunk (both GEMMs)
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // 8 warps: 2 (rows) x 4 (cols)
constexpr int A_LD = BK + 8;     // padded smem strides (bf16 elements):
constexpr int B_LD = BN + 8;     // ldmatrix rows land in distinct banks
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int MAX_E = 8;

enum Role { FIRST = 0, STD = 1, FINAL = 2 };

struct Args {
  int T, n_valid, C, M, d, n_half, E, rs_out;
  const bf16* x;         // STD/FINAL: hidden [B,T,C]; FIRST: x0 [B,T,n_half]
  const bf16* spect;     // [B,T,M]
  const bf16* w_in;      // STD/FINAL: [3,C,2C]; FIRST: composed wp [3,n_half,2C]
  const float* b_in;     // [2C] (FIRST: b_in + folded tap bias)
  const float* b_edge;   // FIRST: [2,2C] left/right folded-bias corrections
  const bf16* w_cond;    // [M,2C]
  const float* b_cond;   // [2C]
  const bf16* w_rs;      // STD/FIRST: [C,rs_out]; FINAL: w_rs@w_end [C,E]
  const float* b_rs;     // STD/FIRST: [rs_out]
  const bf16* acc;       // STD/FINAL: running skip sum [B,T,C]
  const bf16* start_k;   // FIRST: [n_half,C]
  const float* start_b;  // FIRST: [C]
  const bf16* w_end;     // FINAL: [C,E]
  const float* b_end;    // FINAL: [E] (= b_rs@w_end + b_end)
  bf16* x_out;           // STD/FIRST: [B,T,C]
  bf16* skip_out;        // STD/FIRST: [B,T,C]; STD may alias acc
  float* out;            // FINAL: [B,T,E]
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(a);
  v.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// --- in-act GEMM: [BM, K] x [K, 64 tanh + 64 sigmoid cols] ---------------

// K rows of the combined weight: [0, KX) are the three taps of w_in
// (STD/FINAL; KX = 3C), [KX, KX + M) are w_cond.  FIRST has KX = 0: its
// taps are rank n_half and added by FMA in the gate epilogue.
template <int ROLE>
__device__ __forceinline__ void load_inact_stage(const Args& a, int b, int t0,
                                                 int c0, int ks, bf16* sA,
                                                 bf16* sB) {
  const int tid = threadIdx.x;
  const int C2 = 2 * a.C;
  const int KX = (ROLE == FIRST) ? 0 : 3 * a.C;
  const int k0 = ks * BK;
  {  // A: BM rows x BK bf16, one 16-byte chunk per thread
    const int r = tid >> 2, seg = tid & 3;
    const int t = t0 + r;
    const bf16* src = a.spect;
    bool ok;
    if (k0 < KX) {
      const int tap = k0 / a.C, kc = k0 - tap * a.C;
      const int s = t + (tap - 1) * a.d;
      ok = t < a.T && s >= 0 && s < a.n_valid;
      if (ok) src = a.x + ((size_t)b * a.T + s) * a.C + kc + seg * 8;
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

template <int ROLE>
__device__ void inact_chunk(const Args& a, int b, int t0, int c0, bf16* sA,
                            bf16* sB, float acc[2][4][4], int wm, int wn,
                            int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  const int nk = (((ROLE == FIRST) ? 0 : 3 * a.C) + a.M) / BK;
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

// FIRST only.  The rank-n_half composed taps are plain FMAs over two small
// shared-memory tables: sX [BM][3][4], the block's tap inputs x0[t+(j-1)d]
// (zero outside [0, n_valid) and past n_half), staged once per block; and
// sW [3][4][BN], the chunk's columns of the composed weights wp, staged
// once per chunk.
constexpr int FIRST_SX = BM * 3 * 4;
constexpr int FIRST_SW = 3 * 4 * BN;

__device__ void stage_first_x(const Args& a, int b, int t0, bf16* sX) {
  for (int idx = threadIdx.x; idx < FIRST_SX; idx += THREADS) {
    const int r = idx / 12, j = (idx / 4) % 3, i = idx % 4;
    const int t = t0 + r, src = t + (j - 1) * a.d;
    const bool ok = t < a.T && src >= 0 && src < a.n_valid && i < a.n_half;
    sX[idx] = ok ? a.x[((size_t)b * a.T + src) * a.n_half + i]
                 : __float2bfloat16(0.f);
  }
}

__device__ void stage_first_w(const Args& a, int c0, bf16* sW) {
  for (int idx = threadIdx.x; idx < FIRST_SW; idx += THREADS) {
    const int col = idx % BN, ji = idx / BN, j = ji / 4, i = ji % 4;
    const int gcol = col < HALF ? c0 + col : a.C + c0 + col - HALF;
    sW[idx] = i < a.n_half
                  ? a.w_in[((size_t)j * a.n_half + i) * 2 * a.C + gcol]
                  : __float2bfloat16(0.f);
  }
}

// Composed taps of row `row` for tile column `cl` (global column col),
// plus the folded-bias edge corrections (wn_block.py:140).
__device__ __forceinline__ float first_taps(const Args& a, const bf16* sX,
                                            const bf16* sW, int row, int t,
                                            int cl, int col) {
  float s = 0.f;
#pragma unroll
  for (int ji = 0; ji < 12; ++ji)
    s += bf2f(sX[row * 12 + ji]) * bf2f(sW[ji * BN + cl]);
  if (t < a.d) s -= a.b_edge[col];
  if (t >= a.n_valid - a.d) s -= a.b_edge[2 * a.C + col];
  return s;
}

// Gate one chunk in f32 and store it as bf16 into the [BM, C] smem tile.
template <int ROLE>
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ct = c + e, cs = a.C + c + e;
          float at = acc[mi][ni][jp * 2 + e] + a.b_in[ct] + a.b_cond[ct];
          float as = acc[mi][ni + 2][jp * 2 + e] + a.b_in[cs] + a.b_cond[cs];
          if (ROLE == FIRST && t < a.T) {
            const int cl = wn * 16 + ni * 8 + 2 * tq + e;
            at += first_taps(a, sX, sW, row, t, cl, ct);
            as += first_taps(a, sX, sW, row, t, HALF + cl, cs);
          }
          v[e] = tanhf(at) * (1.f / (1.f + expf(-as)));
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

template <int ROLE>
__device__ void rs_phase(const Args& a, int b, int t0, bf16* sB,
                         const bf16* sG, int G_LD, int wm, int wn, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const int nk = a.C / BK;
  const bool has_res = a.rs_out == 2 * a.C;
  for (int n0 = 0; n0 < a.rs_out; n0 += BN) {
    float acc[2][4][4];
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
                base0 = a.start_b[n];
                base1 = a.start_b[n + 1];
                const bf16* xr = a.x + ((size_t)b * a.T + t) * a.n_half;
                for (int i = 0; i < a.n_half; ++i) {
                  const float xv = bf2f(xr[i]);
                  base0 += xv * bf2f(a.start_k[(size_t)i * a.C + n]);
                  base1 += xv * bf2f(a.start_k[(size_t)i * a.C + n + 1]);
                }
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

// FINAL: (acts @ w_rs' + skip_acc @ w_end + b') as plain FMAs, N = E <= 8.
__device__ void final_phase(const Args& a, int b, int t0, const bf16* sG,
                            int G_LD) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int t = t0 + r;
  float s1[MAX_E], s2[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) s1[e] = s2[e] = 0.f;
  if (t < a.T) {
    const bf16* accr = a.acc + ((size_t)b * a.T + t) * a.C;
    for (int c = q; c < a.C; c += 4) {
      const float gv = bf2f(sG[r * G_LD + c]);
      const float av = bf2f(accr[c]);
#pragma unroll
      for (int e = 0; e < MAX_E; ++e) {
        if (e < a.E) {
          s1[e] += gv * bf2f(a.w_rs[(size_t)c * a.E + e]);
          s2[e] += av * bf2f(a.w_end[(size_t)c * a.E + e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], 1);
    s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], 2);
    s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], 1);
    s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], 2);
  }
  if (q == 0 && t < a.T) {
    float* o = a.out + ((size_t)b * a.T + t) * a.E;
    for (int e = 0; e < a.E; ++e) o[e] = s1[e] + s2[e] + a.b_end[e];
  }
}

template <int ROLE>
__global__ void __launch_bounds__(THREADS) wn_layer_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * A_STAGE;
  bf16* sG = sB + STAGES * B_STAGE;
  const int G_LD = a.C + 8;
  bf16* sX = sG + BM * G_LD;  // FIRST only
  bf16* sW = sX + FIRST_SX;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  if (ROLE == FIRST) stage_first_x(a, b, t0, sX);
  for (int c0 = 0; c0 < a.C; c0 += HALF) {
    float acc[2][4][4];
    if (ROLE == FIRST) {  // the previous chunk's gate_store has read sW
      __syncthreads();
      stage_first_w(a, c0, sW);
    }
    // the mainloop's barriers publish sX/sW before gate_store reads them
    inact_chunk<ROLE>(a, b, t0, c0, sA, sB, acc, wm, wn, lane);
    gate_store<ROLE>(a, b, t0, c0, acc, sG, G_LD, sX, sW, wm, wn, lane);
  }
  __syncthreads();
  if (ROLE == FINAL)
    final_phase(a, b, t0, sG, G_LD);
  else
    rs_phase<ROLE>(a, b, t0, sB, sG, G_LD, wm, wn, lane);
}

template <int ROLE>
int launch(const Args& a, int B, void* stream) {
  const size_t smem =
      (size_t)(STAGES * (A_STAGE + B_STAGE) + BM * (a.C + 8) +
               (ROLE == FIRST ? FIRST_SX + FIRST_SW : 0)) *
      sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      wn_layer_kernel<ROLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + BM - 1) / BM, B);
  wn_layer_kernel<ROLE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
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
  a.T = T; a.n_valid = n_valid; a.C = C; a.M = M; a.d = d;
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
  a.T = T; a.n_valid = n_valid; a.C = C; a.M = M; a.d = d;
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
  a.T = T; a.n_valid = n_valid; a.C = C; a.M = M; a.d = d; a.E = E;
  a.x = (const bf16*)x; a.spect = (const bf16*)spect;
  a.w_in = (const bf16*)w_in; a.b_in = (const float*)b_in;
  a.w_cond = (const bf16*)w_cond; a.b_cond = (const float*)b_cond;
  a.w_rs = (const bf16*)w_rs_end; a.acc = (const bf16*)skip_acc;
  a.w_end = (const bf16*)w_end; a.b_end = (const float*)b_end;
  a.out = (float*)out;
  return launch<FINAL>(a, B, stream);
}

}  // extern "C"
