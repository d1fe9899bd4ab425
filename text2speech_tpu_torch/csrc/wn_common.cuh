// Device helpers shared by the WN-layer kernels (wn_block.cu: bf16;
// wn_block_int8.cu: int8): the block shape, cp.async / ldmatrix / mma.sync
// wrappers, the first layer's rank-n_half composed taps and the final
// layer's rank-E end projection.  Everything lives in an anonymous
// namespace: each .cu that includes this file gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;           // rows per block
constexpr int HALF = 64;         // gate-pair chunk: 64 tanh + 64 sigmoid cols
constexpr int BN = 2 * HALF;     // columns per GEMM chunk (both GEMMs)
constexpr int STAGES = 3;        // cp.async pipeline depth
constexpr int THREADS = 256;     // 8 warps: 2 (rows) x 4 (cols)
constexpr int MAX_E = 8;

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

// Four 8x8 matrices of 16-bit elements (= 8 rows x 16 bytes: the same
// instruction loads int8 fragments, 16 k-values per matrix row).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
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

// s8 x s8 -> s32, A [16, 32] row-major, B [32, 8] column-major (4
// consecutive k of one column per register).
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(a);
  v.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ float gate_f32(float at, float as) {
  return tanhf(at) * (1.f / (1.f + expf(-as)));
}

// --- first layer: rank-n_half composed taps ------------------------------
//
// Plain FMAs over two small shared-memory tables: sX [BM][3][4], the
// block's tap inputs x0[t+(j-1)d] (zero outside [0, n_valid) and past
// n_half), staged once per block; and sW [3][4][BN], the chunk's columns
// of the composed weights wp [3, n_half, 2C], staged once per chunk.
constexpr int FIRST_SX = BM * 3 * 4;
constexpr int FIRST_SW = 3 * 4 * BN;

__device__ void stage_first_x(const bf16* x0, int b, int T, int n_valid,
                              int d, int n_half, int t0, bf16* sX) {
  for (int idx = threadIdx.x; idx < FIRST_SX; idx += THREADS) {
    const int r = idx / 12, j = (idx / 4) % 3, i = idx % 4;
    const int t = t0 + r, src = t + (j - 1) * d;
    const bool ok = t < T && src >= 0 && src < n_valid && i < n_half;
    sX[idx] = ok ? x0[((size_t)b * T + src) * n_half + i]
                 : __float2bfloat16(0.f);
  }
}

__device__ void stage_first_w(const bf16* wp, int C, int n_half, int c0,
                              bf16* sW) {
  for (int idx = threadIdx.x; idx < FIRST_SW; idx += THREADS) {
    const int col = idx % BN, ji = idx / BN, j = ji / 4, i = ji % 4;
    const int gcol = col < HALF ? c0 + col : C + c0 + col - HALF;
    sW[idx] = i < n_half ? wp[((size_t)j * n_half + i) * 2 * C + gcol]
                         : __float2bfloat16(0.f);
  }
}

// Composed taps of row `row` (time t) for tile column `cl` (global column
// col of 2C), minus the folded start bias where a tap reads past an edge
// (b_edge [2, 2C]: left, right).
__device__ __forceinline__ float first_taps(const bf16* sX, const bf16* sW,
                                            const float* b_edge, int C, int d,
                                            int n_valid, int row, int t,
                                            int cl, int col) {
  float s = 0.f;
#pragma unroll
  for (int ji = 0; ji < 12; ++ji)
    s += bf2f(sX[row * 12 + ji]) * bf2f(sW[ji * BN + cl]);
  if (t < d) s -= b_edge[col];
  if (t >= n_valid - d) s -= b_edge[2 * C + col];
  return s;
}

// Residual base of the first layer: x0[t] @ start_k + start_b at columns
// n, n + 1.
__device__ __forceinline__ void first_base(const bf16* x0, const bf16* start_k,
                                           const float* start_b, int b, int T,
                                           int C, int n_half, int t, int n,
                                           float& base0, float& base1) {
  base0 = start_b[n];
  base1 = start_b[n + 1];
  const bf16* xr = x0 + ((size_t)b * T + t) * n_half;
  for (int i = 0; i < n_half; ++i) {
    const float xv = bf2f(xr[i]);
    base0 += xv * bf2f(start_k[(size_t)i * C + n]);
    base1 += xv * bf2f(start_k[(size_t)i * C + n + 1]);
  }
}

// --- final layer: gated [BM, C] (bf16, smem) -> [BM, E] -----------------
//
// out = acts @ w_eff + skip_acc @ w_end + b_eff as plain FMAs (N = E <= 8),
// bf16 products with f32 sums; w_eff = w_rs @ w_end and b_eff = b_rs @
// w_end + b_end are folded once per checkpoint by the caller.
__device__ void final_phase(const bf16* skip_acc, const bf16* w_eff,
                            const bf16* w_end, const float* b_eff, float* out,
                            int b, int T, int C, int E, int t0,
                            const bf16* sG, int G_LD) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int t = t0 + r;
  float s1[MAX_E], s2[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) s1[e] = s2[e] = 0.f;
  if (t < T) {
    const bf16* accr = skip_acc + ((size_t)b * T + t) * C;
    for (int c = q; c < C; c += 4) {
      const float gv = bf2f(sG[r * G_LD + c]);
      const float av = bf2f(accr[c]);
#pragma unroll
      for (int e = 0; e < MAX_E; ++e) {
        if (e < E) {
          s1[e] += gv * bf2f(w_eff[(size_t)c * E + e]);
          s2[e] += av * bf2f(w_end[(size_t)c * E + e]);
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
  if (q == 0 && t < T) {
    float* o = out + ((size_t)b * T + t) * E;
    for (int e = 0; e < E; ++e) o[e] = s1[e] + s2[e] + b_eff[e];
  }
}

}  // namespace
