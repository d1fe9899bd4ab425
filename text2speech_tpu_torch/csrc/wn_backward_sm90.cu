// Backward of the WN layers' k=3 dilated SAME conv, redesigned for Hopper
// (sm_90a): bf16 on wgmma with TMA, f32 on a register-tiled FMA GEMM.
//
//   replaces text2speech_tpu/ops/pallas/wn_backward.py:83 conv_k3_bwd_pallas
//            (pallas_call :96, body _bwd_kernel :44)
//
// Forward, channels-last, zero padding, dilation d, per utterance:
//
//   y[t]  = x[t-d] W0 + x[t] W1 + x[t+d] W2           x [T, C], W [3, C, 2C]
//
// Backward, from the cotangent g [T, 2C], rows outside [0, T) reading as
// zero:
//
//   dx[t] = g[t+d] W0^T + g[t] W1^T + g[t-d] W2^T     [T, C] in x's type
//   dW_j  = sum over (b, t) of x[t+(j-1)d]^T g[t]     [3, C, 2C], f32
//
// Two products: dx is [rows, K = 3 * 2C] x [K, C] (tap j's A operand is g
// shifted by (1-j)d, its B operand W_j as stored: [C, 2C] with K = 2C
// contiguous); dW_j is [C, rows] x [rows, 2C] (A = x^T shifted by (j-1)d,
// B = g).  12 B T C 2C FLOP in all: 37.7 GFLOP at B=3, T=2000, C=512,
// against 37 MB of inputs and outputs, so the function is bound by
// operations on an H100: 0.038 ms in bf16 (989 TFLOP/s), 0.563 ms in f32
// outside the tensor cores (67 TFLOP/s; TF32 stays off, as the trainer has
// it, since a one-pass TF32 product would change the numerics).
//
// wn_backward.cu keeps the first design (64-row blocks, mma.sync and an
// FMA path of 4 x 4 outputs a thread with a divide in every element's
// load: 2.9 ms in f32, 2.25x cuDNN); its entry t2s_conv_k3_bwd stays
// exported so that the two can be timed side by side, and nothing else
// calls it.
//
// One launch holds both products: blocks [0, n_dx) own dx tiles, the rest
// dW tiles, so that the two fill the card together.  dW is a split
// reduction over rows: split s of an output tile sums its share of the
// (b, t) stages into an f32 partial [3, S, C, 2C], and a second kernel adds
// the S partials in a fixed order.  No atomics: the result is the same from
// run to run.  The wrapper (ops/wn_backward.py bwd_plan) picks S so that
// no dW block outlasts a dx block or one block slot's share of the work
// (S = 2 in bf16 and 4 in f32 at the shape above: 25 and 50 MB of
// partials written and read).
//
// bf16, C % 128 == 0 (conv_bwd_sm90_kernel).  Warp-specialised, as
// wn_block_sm90.cu: one producer warpgroup whose one thread issues TMA
// loads into a ring of four 48 KB stages (full/empty mbarriers), two
// consumer warpgroups of 64 rows that run wgmma m64n256k16 (bf16 -> f32)
// on them, setmaxnreg 216 / 72.  A block's tile is [128, 256], K = 64 per
// stage; every stage is one A tile of 16 KB and one B tile of 32 KB:
//
// * dx: A = a [128 t, 64 o] box of g at row t0 + (1-j)d, K-major (o
//   contiguous, 128-byte swizzle).  g's map has T extent T, so TMA's
//   out-of-bounds zero fill, negative coordinates included, is the conv's
//   zero padding: no halo is gathered by hand.  One stage lies inside one
//   tap (64 divides 2C).  B = a [256 c, 64 o] box of W_j: K-major too, from
//   a map of rank 3 so that columns c >= C read zero.  Grid ceil(T / 128) x
//   ceil(C / 256) x B tiles of 3 * 2C / 64 stages (48 at C = 512).
// * dW: A = x^T: two [64 t, 64 c] boxes of x at row t0 + (j-1)d (zero
//   fill), c contiguous: wgmma's MN-major A (the transpose bit), one box
//   per consumer warpgroup.  B = four [64 t, 64 o] boxes of g: MN-major B,
//   as wn_block_sm90.cu reads w_in.  A stage is 64 rows of one utterance;
//   rows past T read zero from g's map, so a ragged T needs no mask.  3 x
//   C/128 x 2C/256 output tiles (48 at C = 512), each in S splits.
//
// f32, and bf16 at other widths (C % 8 == 0; conv_bwd_fma_kernel).  A
// [128, 128] tile per block of 256 threads, 8 x 8 outputs a thread in
// registers, K = 16 per stage in a three-stage cp.async ring of 16-byte
// copies, two blocks per SM.  The stage layout follows the operands'
// contiguity, so no copy transposes: dx's operands (g rows, W_j rows) both
// run along K and lie [row][k] (padded to 20 floats: the quarter-warp's
// 16-byte reads at a row stride of 80 bytes hit distinct banks), each
// thread reading float4s along K for rows ty + 16 i and columns tx + 16 i;
// dW's (x rows, g rows) both run along M / N and lie [k][m], each thread
// reading float4s of its rows 4 ty + {0..3} (+ 64) and columns 4 tx +
// {0..3} (+ 64).  A stage lies inside one tap (16 divides 2C) or one
// utterance, and row bounds are computed once per stage: no integer divide
// in the load path.  Per K step of 4 a thread issues 16 shared loads for
// 256 FMAs (dW) or 24 (dx, whose A rows are taken in two halves to stay
// within the 128 registers that two blocks per SM leave a thread).
//
// A wait on an mbarrier that does not complete within seconds traps (a
// launch error) instead of hanging the card.  Measured times are in
// PERF.md.

#include <string.h>

#include "sm90.cuh"

namespace {

// --- bf16: wgmma + TMA ------------------------------------------------------

constexpr int BM = 128;              // tile rows: two consumer warpgroups
constexpr int BN = 256;              // tile columns: one wgmma N
constexpr int BK = 64;               // K per stage: 128-byte rows
constexpr int NWG = 2;
constexpr int BOX = 64 * BK * 2;     // one [64, 64] bf16 box: 8 KB
constexpr int A_BYTES = BM * BK * 2;        // 16 KB
constexpr int STAGE = A_BYTES + BN * BK * 2;  // 48 KB
constexpr int STAGES = 4;

struct Params {
  CUtensorMap tm_g;    // g [B, T, 2C]; box {64, 128, 1}: dx's A
  CUtensorMap tm_w;    // w [3, C, 2C]; box {64, 256, 1}: dx's B
  CUtensorMap tm_x;    // x [B, T, C]; box {64, 64, 1}: dW's A
  CUtensorMap tm_gw;   // g [B, T, 2C]; box {64, 64, 1}: dW's B
  int B, T, C, d, S;
  int n_dx;            // dx blocks
  bf16* dx;            // [B, T, C]
  float* partial;      // [3 S, C, 2C]
};

// What one block computes: a dx tile (t0 rows, c0 columns, utterance b) or
// split s of the dW_j tile (m0 rows of C, n0 columns of 2C), and its
// stages [k_begin, k_end).
struct Work {
  bool dx;
  int b, t0, c0, j, s, m0, n0, k_begin, k_end;
};

__device__ __forceinline__ Work decode(const Params& p) {
  Work w;
  int idx = blockIdx.x;
  w.dx = idx < p.n_dx;
  if (w.dx) {
    const int tm = (p.T + BM - 1) / BM, nc = (p.C + BN - 1) / BN;
    w.t0 = (idx % tm) * BM;
    idx /= tm;
    w.c0 = (idx % nc) * BN;
    w.b = idx / nc;
    w.k_begin = 0;
    w.k_end = 3 * (2 * p.C / BK);
  } else {
    idx -= p.n_dx;
    const int mt = p.C / BM, nt = 2 * p.C / BN;
    w.s = idx % p.S;
    idx /= p.S;
    w.m0 = (idx % mt) * BM;
    idx /= mt;
    w.n0 = (idx % nt) * BN;
    w.j = idx / nt;
    const long long total = (long long)p.B * ((p.T + BK - 1) / BK);
    w.k_begin = (int)(total * w.s / p.S);
    w.k_end = (int)(total * (w.s + 1) / p.S);
  }
  return w;
}

__device__ void produce(const Params& p, const Work& w, uint8_t* ring,
                        uint64_t* full, uint64_t* empty) {
  const int ko = 2 * p.C / BK;            // dx: stages per tap
  const int nt = (p.T + BK - 1) / BK;     // dW: stages per utterance
  int b = 0, t0 = 0;
  if (!w.dx) {
    b = w.k_begin / nt;
    t0 = (w.k_begin - b * nt) * BK;
  }
  Ring r;
  for (int ks = w.k_begin; ks < w.k_end; ++ks) {
    mbar_wait(&empty[r.st], r.ph ^ 1);
    uint8_t* a = ring + r.st * STAGE;
    uint8_t* bs = a + A_BYTES;
    uint64_t* bar = &full[r.st];
    mbar_expect_tx(bar, STAGE);
    if (w.dx) {
      const int j = ks / ko, o0 = (ks - j * ko) * BK;
      tma_load_3d(a, &p.tm_g, o0, w.t0 + (1 - j) * p.d, w.b, bar);
      tma_load_3d(bs, &p.tm_w, o0, w.c0, j, bar);
    } else {
      const int src = t0 + (w.j - 1) * p.d;
      tma_load_3d(a, &p.tm_x, w.m0, src, b, bar);
      tma_load_3d(a + BOX, &p.tm_x, w.m0 + 64, src, b, bar);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load_3d(bs + q * BOX, &p.tm_gw, w.n0 + 64 * q, t0, b, bar);
      t0 += BK;
      if (t0 >= p.T) {
        t0 = 0;
        ++b;
      }
    }
    r.next(STAGES);
  }
}

// One form per product, so that each holds its own accumulators and its
// loop issues one kind of wgmma.
template <bool DX>
__device__ void consume(const Params& p, const Work& w, uint8_t* ring,
                        uint64_t* full, uint64_t* empty, int wg, int tid) {
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  Ring r;
  int prev = -1;
  for (int ks = w.k_begin; ks < w.k_end; ++ks) {
    mbar_wait(&full[r.st], r.ph);
    const uint32_t a = smem_u32(ring + r.st * STAGE) + wg * (A_BYTES / 2);
    const uint32_t bs = smem_u32(ring + r.st * STAGE) + A_BYTES;
    wgmma_fence();
    if (DX) {
      // K-major A and B: rows of 64 bf16 (128 bytes), 128-byte swizzle,
      // 8-row groups 1024 bytes apart; a k16 step is 32 bytes along a row
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<0, 0>(acc, make_desc(a + kk * 32, 16, 1024, 1),
                         make_desc(bs + kk * 32, 16, 1024, 1), 1);
    } else {
      // MN-major A and B: 64-wide boxes of BK rows (leading offset: one
      // box), 8-row K groups 1024 bytes apart; a k16 step is 16 rows
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<1, 1>(acc, make_desc(a + kk * 2048, BOX, 1024, 1),
                         make_desc(bs + kk * 2048, BOX, 1024, 1), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    prev = r.st;
    r.next(STAGES);
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);

  // accumulator tile j holds columns 8j + 2q + {0, 1} of rows r0, r0 + 8
  const int lane = tid & 31, q = lane & 3;
  const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
  if (DX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = w.t0 + r0 + 8 * h;
      if (t >= p.T) continue;
      bf16* row = p.dx + ((size_t)w.b * p.T + t) * p.C;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = w.c0 + 8 * j + 2 * q;
        if (c < p.C)
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
    const size_t C2 = 2 * (size_t)p.C;
    float* out = p.partial + (size_t)(w.j * p.S + w.s) * p.C * C2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + (size_t)(w.m0 + r0 + 8 * h) * C2 + w.n0 + 2 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    conv_bwd_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Work w = decode(p);
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one branch per role (setmaxnreg needs the paths never to meet again):
  // 2 x 128 x 216 + 128 x 72 registers of 65,536
  if (warp >= NWG * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x == NWG * 128) produce(p, w, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    if (w.dx)
      consume<true>(p, w, ring, full, empty, warp >> 2, threadIdx.x & 127);
    else
      consume<false>(p, w, ring, full, empty, warp >> 2, threadIdx.x & 127);
  }
}

constexpr size_t SM90_SMEM = 1024 + (size_t)STAGES * STAGE;

int launch_sm90(const void* x, const void* g, const void* w, void* dx,
                void* partial, int B, int T, int C, int d, int S,
                cudaStream_t st) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.B = B; p.T = T; p.C = C; p.d = d; p.S = S;
  p.dx = (bf16*)dx;
  p.partial = (float*)partial;
  const cuuint64_t uC = C, uT = T, uB = B;
  int e;
  {  // g [B, T, 2C]: dx's A ([128 t, 64 o]) and dW's B ([64 t, 64 o])
    const cuuint64_t dims[3] = {2 * uC, uT, uB};
    const cuuint64_t str[2] = {2 * uC * 2, uT * 2 * uC * 2};
    const cuuint32_t box_a[3] = {64, BM, 1}, box_b[3] = {64, BK, 1};
    if ((e = encode(&p.tm_g, g, 3, dims, str, box_a,
                    CU_TENSOR_MAP_SWIZZLE_128B)) ||
        (e = encode(&p.tm_gw, g, 3, dims, str, box_b,
                    CU_TENSOR_MAP_SWIZZLE_128B)))
      return e;
  }
  {  // w [3, C, 2C]: dx's B ([256 c, 64 o]), c >= C zero
    const cuuint64_t dims[3] = {2 * uC, uC, 3};
    const cuuint64_t str[2] = {2 * uC * 2, uC * 2 * uC * 2};
    const cuuint32_t box[3] = {64, BN, 1};
    if ((e = encode(&p.tm_w, w, 3, dims, str, box,
                    CU_TENSOR_MAP_SWIZZLE_128B)))
      return e;
  }
  {  // x [B, T, C]: dW's A ([64 t, 64 c])
    const cuuint64_t dims[3] = {uC, uT, uB};
    const cuuint64_t str[2] = {uC * 2, uT * uC * 2};
    const cuuint32_t box[3] = {64, BK, 1};
    if ((e = encode(&p.tm_x, x, 3, dims, str, box,
                    CU_TENSOR_MAP_SWIZZLE_128B)))
      return e;
  }
  p.n_dx = ((T + BM - 1) / BM) * ((C + BN - 1) / BN) * B;
  const int n_dw = 3 * (C / BM) * (2 * C / BN) * S;
  cudaError_t ce = cudaFuncSetAttribute(
      conv_bwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SM90_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  conv_bwd_sm90_kernel<<<p.n_dx + n_dw, (NWG + 1) * 128, SM90_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

// --- f32 (and bf16 at other widths): register-tiled FMA GEMM ---------------

constexpr int FT = 128;       // tile rows and columns
constexpr int FK = 16;        // K per stage
constexpr int F_STAGES = 3;
constexpr int F_THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = smem_u32(smem);
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of shared memory as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T_>
struct Fma {
  static constexpr int VEC = 16 / sizeof(T_);  // elements per 16-byte copy
  static constexpr int PAD = VEC;              // 16 bytes of padding a row
  // dx: [FT rows][FK + PAD]; dW: [FK rows][FT + PAD], for A and for B
  static constexpr int LDX = FK + PAD, LDW = FT + PAD;
  static constexpr int OPND = FT * LDX > FK * LDW ? FT * LDX : FK * LDW;
  static constexpr int STAGE = 2 * OPND;       // elements
  static constexpr size_t SMEM = (size_t)F_STAGES * STAGE * sizeof(T_);
};

struct FParams {
  const void *x, *g, *w;
  void* dx;
  float* partial;
  int B, T, C, d, S, n_dx;
};

// One stage of a dx tile: A rows t0 + r of g shifted by (1-j)d, B rows
// c0 + r of W_j; columns [o0, o0 + FK) of 2C.
template <typename T_>
__device__ __forceinline__ void fma_load_dx(const FParams& p, int b, int t0,
                                            int c0, int j, int o0,
                                            T_* sA, T_* sB) {
  using F = Fma<T_>;
  constexpr int CPR = FK / F::VEC;  // copies per row
  const T_* g = (const T_*)p.g;
  const T_* w = (const T_*)p.w;
  const int C2 = 2 * p.C;
  const int shift = (1 - j) * p.d;
  static_assert(FT * CPR % F_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int u = 0; u < FT * CPR / F_THREADS; ++u) {
    const int i = threadIdx.x + u * F_THREADS;
    const int r = i / CPR, kc = (i % CPR) * F::VEC;
    const int t = t0 + r, src = t + shift;
    const bool oka = t < p.T && src >= 0 && src < p.T;
    cp_async16(sA + r * F::LDX + kc,
               oka ? g + ((size_t)b * p.T + src) * C2 + o0 + kc : g, oka);
    const int c = c0 + r;
    const bool okb = c < p.C;
    cp_async16(sB + r * F::LDX + kc,
               okb ? w + ((size_t)j * p.C + c) * C2 + o0 + kc : w, okb);
  }
}

// One stage of a dW tile: rows [t0, t0 + FK) of utterance b; A = x rows
// shifted by (j-1)d, columns [m0, m0 + FT) of C; B = g, columns [n0, n0 +
// FT) of 2C.
template <typename T_>
__device__ __forceinline__ void fma_load_dw(const FParams& p, int b, int t0,
                                            int j, int m0, int n0, T_* sA,
                                            T_* sB) {
  using F = Fma<T_>;
  constexpr int CPR = FT / F::VEC;
  const T_* x = (const T_*)p.x;
  const T_* g = (const T_*)p.g;
  const int C2 = 2 * p.C;
  const int shift = (j - 1) * p.d;
  static_assert(FK * CPR % F_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int u = 0; u < FK * CPR / F_THREADS; ++u) {
    const int i = threadIdx.x + u * F_THREADS;
    const int r = i / CPR, mc = (i % CPR) * F::VEC;
    const int t = t0 + r, src = t + shift;
    const bool oka = t < p.T && src >= 0 && src < p.T && m0 + mc < p.C;
    cp_async16(sA + r * F::LDW + mc,
               oka ? x + ((size_t)b * p.T + src) * p.C + m0 + mc : x, oka);
    const bool okb = t < p.T && n0 + mc < C2;
    cp_async16(sB + r * F::LDW + mc,
               okb ? g + ((size_t)b * p.T + t) * C2 + n0 + mc : g, okb);
  }
}

template <typename T_>
__global__ void __launch_bounds__(F_THREADS, 2)
    conv_bwd_fma_kernel(const FParams p) {
  using F = Fma<T_>;
  extern __shared__ __align__(16) uint8_t fsmem[];
  T_* sm = reinterpret_cast<T_*>(fsmem);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int C2 = 2 * p.C;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;

  int idx = blockIdx.x;
  const bool is_dx = idx < p.n_dx;
  // dx: tile (b, t0, c0), stages over (j, o0); dW: tile (j, m0, n0), split
  // s, stages over (b, t0)
  int b = 0, t0 = 0, c0 = 0, j = 0, m0 = 0, n0 = 0, k_n;
  if (is_dx) {
    const int tm = (p.T + FT - 1) / FT, nc = (p.C + FT - 1) / FT;
    t0 = (idx % tm) * FT;
    idx /= tm;
    c0 = (idx % nc) * FT;
    b = idx / nc;
    k_n = 3 * (C2 / FK);
  } else {
    idx -= p.n_dx;
    const int mt = (p.C + FT - 1) / FT, ntl = (C2 + FT - 1) / FT;
    const int s = idx % p.S;
    idx /= p.S;
    m0 = (idx % mt) * FT;
    idx /= mt;
    n0 = (idx % ntl) * FT;
    j = idx / ntl;
    const int nt = (p.T + FK - 1) / FK;
    const long long total = (long long)p.B * nt;
    const int k_begin = (int)(total * s / p.S);
    k_n = (int)(total * (s + 1) / p.S) - k_begin;
    b = k_begin / nt;
    t0 = (k_begin - b * nt) * FK;
  }
  // the position of the next stage to load (advanced by `load`)
  int lj = 0, lo = 0, lb = b, lt = t0;
  auto load = [&](int slot) {
    T_* sA = sm + slot * F::STAGE;
    T_* sB = sA + F::OPND;
    if (is_dx) {
      fma_load_dx<T_>(p, b, t0, c0, lj, lo, sA, sB);
      lo += FK;
      if (lo == C2) {
        lo = 0;
        ++lj;
      }
    } else {
      fma_load_dw<T_>(p, lb, lt, j, m0, n0, sA, sB);
      lt += FK;
      if (lt >= p.T) {
        lt = 0;
        ++lb;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < k_n) load(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < k_n; ++ks) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    const int kn = ks + F_STAGES - 1;
    if (kn < k_n) load(kn % F_STAGES);
    cp_async_commit();
    const T_* sA = sm + (ks % F_STAGES) * F::STAGE;
    const T_* sB = sA + F::OPND;
    if (is_dx) {
      // [row][k]: rows ty + 16 i of A, tx + 16 n of B, float4s along k;
      // A's rows in two halves of four, so that 16 of them are live
#pragma unroll
      for (int k4 = 0; k4 < FK; k4 += 4) {
#pragma unroll
        for (int i0 = 0; i0 < 8; i0 += 4) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = ld4(sA + (ty + 16 * (i0 + i)) * F::LDX + k4);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float4 bv = ld4(sB + (tx + 16 * n) * F::LDX + k4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float& c = acc[i0 + i][n];
              c = fmaf(a[i].x, bv.x, c);
              c = fmaf(a[i].y, bv.y, c);
              c = fmaf(a[i].z, bv.z, c);
              c = fmaf(a[i].w, bv.w, c);
            }
          }
        }
      }
    } else {
      // [k][m]: rows 4 ty + {0..3} (+ 64) of A, columns 4 tx + {0..3}
      // (+ 64) of B
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a0 = ld4(sA + k * F::LDW + 4 * ty);
        const float4 a1 = ld4(sA + k * F::LDW + 64 + 4 * ty);
        const float4 b0 = ld4(sB + k * F::LDW + 4 * tx);
        const float4 b1 = ld4(sB + k * F::LDW + 64 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
      }
    }
  }
  cp_async_wait<0>();

  if (is_dx) {
    T_* dx = (T_*)p.dx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= p.T) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + tx + 16 * n;
        if (c < p.C) st1(dx + ((size_t)b * p.T + t) * p.C + c, acc[i][n]);
      }
    }
  } else {
    const int s = (blockIdx.x - p.n_dx) % p.S;
    float* out = p.partial + (size_t)(j * p.S + s) * p.C * C2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
      if (m >= p.C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 4 * tx + 64 * h;
        if (n < C2)   // C % 8 == 0: four columns are all in or all out
          *reinterpret_cast<float4*>(out + (size_t)m * C2 + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

template <typename T_>
int launch_fma(const void* x, const void* g, const void* w, void* dx,
               void* partial, int B, int T, int C, int d, int S,
               cudaStream_t st) {
  FParams p{x, g, w, dx, (float*)partial, B, T, C, d, S, 0};
  p.n_dx = ((T + FT - 1) / FT) * ((C + FT - 1) / FT) * B;
  const int n_dw = 3 * ((C + FT - 1) / FT) * ((2 * C + FT - 1) / FT) * S;
  constexpr size_t smem = Fma<T_>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bwd_fma_kernel<T_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv_bwd_fma_kernel<T_><<<p.n_dx + n_dw, F_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// dW[j] = sum over s, in order, of partial[j S + s]; float4 a thread.
__global__ void dw_reduce_kernel(const float4* __restrict__ partial,
                                 float4* __restrict__ dw, long long per_tap4,
                                 int S) {
  const long long n = 3 * per_tap4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long j = i / per_tap4, e = i - j * per_tap4;
    float4 sum = partial[j * S * per_tap4 + e];
    for (int s = 1; s < S; ++s) {
      const float4 v = partial[(j * S + s) * per_tap4 + e];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    dw[i] = sum;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  x [B, T, C], g [B, T, 2C],
// w [3, C, 2C] of one type (is_bf16), dense and 16-byte aligned; dx
// [B, T, C] of that type; dw [3, C, 2C] f32; partial [3 S, C, 2C] f32
// scratch (with S == 1 the kernel writes dw directly and partial is not
// read).  use_wgmma: the bf16 tensor-core route (C % 128 == 0), else the
// FMA route (C % 8 == 0).  The Python wrapper (ops/wn_backward.py) checks
// all of this and picks S.  Returns 0 or the cudaError_t of a refused
// launch or tensor map (minus its CUresult).
extern "C" {

int t2s_conv_k3_bwd_sm90(const void* x, const void* g, const void* w,
                         void* dx, void* dw, void* partial, int B, int T,
                         int C, int d, int S, int is_bf16, int use_wgmma,
                         void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || d < 0 || S <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  if (use_wgmma && (!is_bf16 || C % BM)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  void* out = S == 1 ? dw : partial;
  int err;
  if (use_wgmma)
    err = launch_sm90(x, g, w, dx, out, B, T, C, d, S, st);
  else if (is_bf16)
    err = launch_fma<bf16>(x, g, w, dx, out, B, T, C, d, S, st);
  else
    err = launch_fma<float>(x, g, w, dx, out, B, T, C, d, S, st);
  if (err || S == 1) return err;
  const long long per_tap4 = (long long)C * 2 * C / 4;
  const long long n = 3 * per_tap4;
  const int blocks = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256
                                                      : 132 * 8);
  dw_reduce_kernel<<<blocks, 256, 0, st>>>((const float4*)partial,
                                           (float4*)dw, per_tap4, S);
  return (int)cudaGetLastError();
}

// The tile of a route (use_wgmma 1 or 0) into out[4]: rows, columns, K per
// stage and blocks per SM (the kernel's launch bounds).  ops/wn_backward.py
// restates them to size the dW split; the chip check holds the two equal.
int t2s_conv_k3_bwd_sm90_tile(int use_wgmma, int* out) {
  const int wgmma[4] = {BM, BN, BK, 1}, fma[4] = {FT, FT, FK, 2};
  memcpy(out, use_wgmma ? wgmma : fma, sizeof(wgmma));
  return 0;
}

}  // extern "C"
