// Backward of the WN layers' k=3 dilated SAME conv, hand-written for Hopper
// (sm_90a).
//
//   replaces text2speech_tpu/ops/pallas/wn_backward.py:83 conv_k3_bwd_pallas
//            (body _bwd_kernel, :44)
//
// Forward, channels-last, zero padding, dilation d, per utterance:
//
//   y[t]  = x[t-d] W0 + x[t] W1 + x[t+d] W2           x [T, C], W [3, C, 2C]
//
// Backward, from the cotangent g [T, 2C]:
//
//   dx[t] = g[t+d] W0^T + g[t] W1^T + g[t-d] W2^T     in x's type
//   dW_j  = sum over (b, t) of x[t+(j-1)d]^T g[t]     [3, C, 2C], f32
//
// rows outside [0, T) reading as zero.
//
// Design.  The TPU kernel pads the time axis by one zero tile each side and
// walks it in order, so that dW can sit in ONE VMEM block that every grid
// step adds to.  CUDA blocks run in no order and share nothing, so:
//
// * nothing is padded: a block reads its halo rows t +- d straight from
//   global memory and zero-fills what falls outside [0, T) (as the port's
//   forward kernels do);
// * dx is one GEMM per 64-row block, [64, K = 3 * 2C] x [K, C], over a
//   gathered A operand (tap j reads g[t + (1-j) d]).  Its B operand is
//   W_j^T, and W_j [C, 2C] as stored IS W_j^T with k contiguous, so the
//   weight stack is neither reversed nor transposed in memory;
// * dW is a split reduction.  Grid z = (tap j, split s): a block owns a
//   [64, 128] tile of dW_j and sums over its share of the (b, t) rows
//   (32-row chunks, dealt round robin) into an f32 partial [3, S, C, 2C];
//   a second kernel adds the S partials in a fixed order.  No atomics: the
//   result is the same from run to run.
//
// Two code paths, chosen by the wrapper from what it can see:
//
// * bf16 with C % 128 == 0: bf16 mma.sync.m16n8k16 with f32 accumulation,
//   fed by ldmatrix from a 3-stage cp.async pipeline (helpers of
//   wn_common.cuh).  dW's A operand is x^T, read with ldmatrix.trans from
//   the [t, c] tile as it lies in memory;
// * anything else (f32, or bf16 at another width): a plain tiled FMA GEMM
//   in f32 through shared memory, exact to f32 rounding, slow.
//
// What bounds it on an H100: operations (12 B T C 2C FLOP; 37.7 GFLOP at
// B=3, T=2000, C=512 against 37 MB moved).  mma.sync with 64-row blocks
// that re-stream the weights from L2 stays far below the wgmma peak, and
// the FMA path further still; wgmma and TMA are later work.

#include "wn_common.cuh"

namespace {

constexpr int BK = 32;
constexpr int AX_LD = BK + 8;   // dx: A [BM][BK], B [BN][BK] (k contiguous)
constexpr int AW_LD = BM + 8;   // dW: A [BK][BM] (x rows as stored)
constexpr int BW_LD = BN + 8;   // dW: B [BK][BN]

__device__ __forceinline__ void zero_acc(float acc[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
}

// ---------------------------------------------------------------------------
// dx, bf16 tensor-core path.  grid (ceil(T / BM), C / BN, B).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dx_load_stage(const bf16* g, const bf16* w,
                                              int b, int T, int C, int d,
                                              int t0, int c0, int ks,
                                              bf16* sA, bf16* sB) {
  const int tid = threadIdx.x;
  const int C2 = 2 * C;
  const int k0 = ks * BK;
  const int j = k0 / C2, o0 = k0 - j * C2;
  {
    const int r = tid >> 2, seg = tid & 3;
    const int t = t0 + r, s = t + (1 - j) * d;
    const bool ok = t < T && s >= 0 && s < T;
    const bf16* src = ok ? g + ((size_t)b * T + s) * C2 + o0 + seg * 8 : g;
    cp_async16(sA + r * AX_LD + seg * 8, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int n = idx >> 2, seg = idx & 3;
    cp_async16(sB + n * AX_LD + seg * 8,
               w + ((size_t)j * C + c0 + n) * C2 + o0 + seg * 8, true);
  }
}

__global__ void __launch_bounds__(THREADS)
    dx_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                  bf16* __restrict__ dx, int T, int C, int d) {
  __shared__ __align__(16) bf16 sA[STAGES][BM * AX_LD];
  __shared__ __align__(16) bf16 sB[STAGES][BN * AX_LD];
  const int t0 = blockIdx.x * BM, c0 = blockIdx.y * BN, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4];
  zero_acc(acc);
  const int nk = 3 * 2 * C / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) dx_load_stage(g, w, b, T, C, d, t0, c0, s, sA[s], sB[s]);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = ks + STAGES - 1;
    if (kn < nk)
      dx_load_stage(g, w, b, T, C, d, t0, c0, kn, sA[kn % STAGES],
                    sB[kn % STAGES]);
    cp_async_commit();
    const bf16* As = sA[ks % STAGES];
    const bf16* Bs = sB[ks % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * AX_LD +
                                kk + (lane >> 4) * 8);
      unsigned bfr[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
        const int row = wn * 32 + h * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, Bs + row * AX_LD + kk + ((lane >> 3) & 1) * 8);
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
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int t = t0 + wm * 32 + mi * 16 + gq + jp * 8;
        if (t >= T) continue;
        const int c = c0 + wn * 32 + ni * 8 + 2 * tq;
        store_bf16x2(dx + ((size_t)b * T + t) * C + c, acc[mi][ni][jp * 2],
                     acc[mi][ni][jp * 2 + 1]);
      }
}

// ---------------------------------------------------------------------------
// dW partials, bf16 tensor-core path.  grid (C / BM, 2C / BN, 3 * S).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dw_load_stage(const bf16* x, const bf16* g,
                                              int T, int C, int d, int j,
                                              int m0, int n0, int q, int nT,
                                              bf16* sA, bf16* sB) {
  const int tid = threadIdx.x;
  const int b = q / nT, tt0 = (q - b * nT) * BK;
  {
    const int kr = tid >> 3, seg = tid & 7;
    const int t = tt0 + kr, s = t + (j - 1) * d;
    const bool ok = t < T && s >= 0 && s < T;
    const bf16* src = ok ? x + ((size_t)b * T + s) * C + m0 + seg * 8 : x;
    cp_async16(sA + kr * AW_LD + seg * 8, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int kr = idx >> 4, seg = idx & 15;
    const int t = tt0 + kr;
    const bool ok = t < T;
    const bf16* src =
        ok ? g + ((size_t)b * T + t) * 2 * C + n0 + seg * 8 : g;
    cp_async16(sB + kr * BW_LD + seg * 8, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
    dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ partial, int B, int T, int C, int d,
                  int S) {
  __shared__ __align__(16) bf16 sA[STAGES][BK * AW_LD];
  __shared__ __align__(16) bf16 sB[STAGES][BK * BW_LD];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int j = blockIdx.z / S, s = blockIdx.z - j * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int nT = (T + BK - 1) / BK;
  const int total = B * nT;
  const int cnt = s < total ? (total - s + S - 1) / S : 0;
  float acc[2][4][4];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < cnt)
      dw_load_stage(x, g, T, C, d, j, m0, n0, s + i * S, nT, sA[i], sB[i]);
    cp_async_commit();
  }
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int in = i + STAGES - 1;
    if (in < cnt)
      dw_load_stage(x, g, T, C, d, j, m0, n0, s + in * S, nT,
                    sA[in % STAGES], sB[in % STAGES]);
    cp_async_commit();
    const bf16* As = sA[i % STAGES];
    const bf16* Bs = sB[i % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // A = x^T: transpose on load
        ldmatrix_x4_trans(af[mi],
                          As + (kk + (lane >> 4) * 8 + (lane & 7)) * AW_LD +
                              wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
      unsigned bfr[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 15)) * BW_LD + wn * 32 +
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
  const int gq = lane >> 2, tq = lane & 3;
  float* out = partial + (size_t)blockIdx.z * C * 2 * C;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int c = m0 + wm * 32 + mi * 16 + gq + jp * 8;
        const int o = n0 + wn * 32 + ni * 8 + 2 * tq;
        float2 v = make_float2(acc[mi][ni][jp * 2], acc[mi][ni][jp * 2 + 1]);
        *reinterpret_cast<float2*>(out + (size_t)c * 2 * C + o) = v;
      }
}

// dW[j] = sum over s (in order) of partial[j * S + s].
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, long long per_tap,
                                 int S) {
  const long long n = 3 * per_tap;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long j = i / per_tap, e = i - j * per_tap;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += partial[(j * S + s) * per_tap + e];
    dw[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// Plain FMA path (f32, or bf16 at widths the tensor-core path does not
// take): a [64, 64] tile per block, 4 x 4 outputs per thread, k in steps of
// 16 through shared memory, f32 throughout.
// ---------------------------------------------------------------------------

constexpr int FT = 64;   // tile rows and columns
constexpr int FK = 16;   // k per step

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc += A(m0.., k) B(k, n0..) over k in [k_begin, k_end).  KFAST says
// which index the loaders' memory runs along (k, or m / n).
template <bool KFAST, typename LA, typename LB>
__device__ void fma_tile(LA load_a, LB load_b, int k_begin, int k_end,
                         float acc[4][4]) {
  __shared__ float sA[FK][FT + 1];
  __shared__ float sB[FK][FT + 1];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
#pragma unroll
    for (int i = 0; i < FT * FK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = KFAST ? e % FK : e / FT;
      const int mn = KFAST ? e / FK : e % FT;
      const bool ok = k0 + kk < k_end;
      sA[kk][mn] = ok ? load_a(mn, k0 + kk) : 0.f;
      sB[kk][mn] = ok ? load_b(k0 + kk, mn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[kk][ty * 4 + i];
        bv[i] = sB[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) acc[i][jn] += a[i] * bv[jn];
    }
    __syncthreads();
  }
}

// grid (ceil(T / 64), ceil(C / 64), B)
template <typename T_>
__global__ void __launch_bounds__(THREADS)
    dx_fma_kernel(const T_* __restrict__ g, const T_* __restrict__ w,
                  T_* __restrict__ dx, int T, int C, int d) {
  const int t0 = blockIdx.x * FT, c0 = blockIdx.y * FT, b = blockIdx.z;
  const int C2 = 2 * C;
  float acc[4][4] = {};
  auto load_a = [&](int m, int k) -> float {
    const int j = k / C2, o = k - j * C2;
    const int t = t0 + m, s = t + (1 - j) * d;
    return (t < T && s >= 0 && s < T)
               ? ldf(g + ((size_t)b * T + s) * C2 + o) : 0.f;
  };
  auto load_b = [&](int k, int n) -> float {
    const int j = k / C2, o = k - j * C2;
    return c0 + n < C ? ldf(w + ((size_t)j * C + c0 + n) * C2 + o) : 0.f;
  };
  fma_tile<true>(load_a, load_b, 0, 3 * C2, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int t = t0 + ty * 4 + i, c = c0 + tx * 4 + jn;
      if (t < T && c < C) stf(dx + ((size_t)b * T + t) * C + c, acc[i][jn]);
    }
}

// grid (ceil(C / 64), ceil(2C / 64), 3 * S); split s sums rows
// [s * per, (s + 1) * per) of the B * T flat rows.
template <typename T_>
__global__ void __launch_bounds__(THREADS)
    dw_fma_kernel(const T_* __restrict__ x, const T_* __restrict__ g,
                  float* __restrict__ partial, int B, int T, int C, int d,
                  int S) {
  const int m0 = blockIdx.x * FT, n0 = blockIdx.y * FT;
  const int j = blockIdx.z / S, s = blockIdx.z - j * S;
  const int C2 = 2 * C;
  const int rows = B * T, per = (rows + S - 1) / S;
  const int k_begin = min(s * per, rows), k_end = min(k_begin + per, rows);
  float acc[4][4] = {};
  auto load_a = [&](int m, int k) -> float {
    const int b = k / T, t = k - b * T, src = t + (j - 1) * d;
    return (m0 + m < C && src >= 0 && src < T)
               ? ldf(x + ((size_t)b * T + src) * C + m0 + m) : 0.f;
  };
  auto load_b = [&](int k, int n) -> float {
    return n0 + n < C2 ? ldf(g + (size_t)k * C2 + n0 + n) : 0.f;
  };
  fma_tile<false>(load_a, load_b, k_begin, k_end, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = partial + (size_t)blockIdx.z * C * C2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int c = m0 + ty * 4 + i, o = n0 + tx * 4 + jn;
      if (c < C && o < C2) out[(size_t)c * C2 + o] = acc[i][jn];
    }
}

template <typename T_>
int launch_fma(const void* x, const void* g, const void* w, void* dx,
               void* dw, void* partial, int B, int T, int C, int d, int S,
               cudaStream_t st) {
  dim3 gx((T + FT - 1) / FT, (C + FT - 1) / FT, B);
  dx_fma_kernel<T_><<<gx, THREADS, 0, st>>>((const T_*)g, (const T_*)w,
                                            (T_*)dx, T, C, d);
  dim3 gw((C + FT - 1) / FT, (2 * C + FT - 1) / FT, 3 * S);
  dw_fma_kernel<T_><<<gw, THREADS, 0, st>>>((const T_*)x, (const T_*)g,
                                            (float*)partial, B, T, C, d, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  x [B, T, C], g [B, T, 2C],
// w [3, C, 2C] of one type (is_bf16), dense; dx [B, T, C] of that type; dw
// [3, C, 2C] f32; partial [3 * S, C, 2C] f32 scratch.  use_mma picks the
// tensor-core path (bf16 and C % 128 == 0 only; checked by the Python
// wrapper).  Returns cudaGetLastError() after the three launches.
extern "C" {

int t2s_conv_k3_bwd(const void* x, const void* g, const void* w, void* dx,
                    void* dw, void* partial, int B, int T, int C, int d,
                    int S, int is_bf16, int use_mma, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || d < 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (use_mma) {
    if (!is_bf16 || C % BN) return (int)cudaErrorInvalidValue;
    dim3 gx((T + BM - 1) / BM, C / BN, B);
    dx_mma_kernel<<<gx, THREADS, 0, st>>>((const bf16*)g, (const bf16*)w,
                                          (bf16*)dx, T, C, d);
    dim3 gw(C / BM, 2 * C / BN, 3 * S);
    dw_mma_kernel<<<gw, THREADS, 0, st>>>((const bf16*)x, (const bf16*)g,
                                          (float*)partial, B, T, C, d, S);
    err = (int)cudaGetLastError();
  } else if (is_bf16) {
    err = launch_fma<bf16>(x, g, w, dx, dw, partial, B, T, C, d, S, st);
  } else {
    err = launch_fma<float>(x, g, w, dx, dw, partial, B, T, C, d, S, st);
  }
  if (err) return err;
  const long long per_tap = (long long)C * 2 * C;
  const int blocks = (int)((3 * per_tap + 255) / 256 < 132 * 16
                               ? (3 * per_tap + 255) / 256 : 132 * 16);
  dw_reduce_kernel<<<blocks, 256, 0, st>>>((const float*)partial, (float*)dw,
                                           per_tap, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
