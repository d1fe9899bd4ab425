// The padded-layout WN-layer family, hand-written for Hopper (sm_90a): the
// port's second, independent implementation of the WN layer, kept (as in
// the JAX package) as the oracle side of the parity ladder.  Nothing here
// is shared with wn_block.cu: no template, taps, gate or epilogue of the
// serving kernels, and no mma.sync.  The products are plain f32 FMAs over
// bf16 values, so they are exact and only the summation order differs
// from the plain PyTorch versions.
//
//   wn_padded_kernel        replaces text2speech_tpu/ops/pallas/
//                           wn_block_padded.py:104 wn_layer_padded
//                           (pallas_call :135, body _kernel_padded,
//                           project_cond=False)
//   wn_spect_kernel         replaces :165 wn_layer_spect (pallas_call :194,
//                           _kernel_padded, project_cond=True)
//   wn_stream_kernel        replaces :302 wn_layer_stream (pallas_call
//                           :334, _kernel_stream, final=False)
//   wn_stream_final_kernel  replaces :353 wn_layer_stream_final
//                           (pallas_call :392, _kernel_stream, final=True)
//
// Layout.  Activations are [B, Tp, C] with Tp = T + 2 * bt: one tile of bt
// zero rows on each side of the T real rows (the wrapper's pad_tiles).
// The pad tiles supply the conv's edge zeros, so every tap row t +- d of a
// real row lies inside [0, Tp) as long as d <= bt: halo rows are read
// straight from global memory, with no bounds test.  Blocks whose rows lie
// in a pad tile write zeros there.  Real rows at or past n_valid get a zero
// hidden-state output; the skip outputs are not masked (as
// _store_layer_out, wn_block.py:105-126).
//
// One layer, per real row t (bf16 IO, f32 math):
//   in_act = x[t-d] w0 + x[t] w1 + x[t+d] w2 + b_in + cond[t]      [2C]
//   cond   = cond_p[t, 2C ci : 2C (ci+1)]             (padded, b_cond in it)
//          | spect[t] @ w_cond + b_cond               (spect, stream, final)
//   g      = bf16( tanh(in_act[:C]) * sigmoid(in_act[C:]) )           [C]
//   rs     = g @ w_rs + b_rs                                  [2C] or [C]
//   x_new  = bf16(x[t] + rs[:C])  (or x[t] when w_rs is [C, C]), 0 past n_valid
//   skip   = bf16(rs[C:])                     (padded: returned as it is)
//          | bf16(skip_acc + bf16(rs[C:]))    (spect, stream: in place)
//   final: wn_out = bf16(skip_acc + rs) @ w_end + b_end   [E] f32, unmasked
//
// Blocks.  One block per (32-row slab, batch row); a pad tile of bt rows is
// bt / 32 slabs.  The in_act GEMM runs in chunks of 32 gate pairs (64
// columns: tanh columns c0.. and their sigmoid partners C + c0..), K staged
// 32 at a time into shared memory as f32; the gate is applied in registers
// and the bf16 gated slab [32, C] waits in shared memory for the res/skip
// GEMM (chunks of 64 output columns).  Two sets of GEMM, gate and epilogue
// code, which share nothing but the layout helpers: the padded and spect
// kernels' (each of the 128 threads holds 4 rows x 2 gate pairs, then 4 x 4
// res/skip columns, weights staged [K][N]) and the stream kernels' (one row
// x 8 gate pairs, then 1 x 16 columns, weights staged transposed).
//
// The skip sum of the spect and stream kernels is updated IN PLACE (the TPU
// kernels alias it through input_output_aliases, wn_block_padded.py:220,
// :347).  That is safe on CUDA only because each block reads the skip_acc
// rows of its own slab and writes those rows alone, and no block reads a
// skip_acc row it does not write.
//
// The spect and stream kernels compute the same contract from two loop
// structures and two sets of GEMM, gate and epilogue code, so that the
// ladder's 13 <-> 14 rung compares two implementations:
//   spect  walks its own slab and both neighbours in one flat K loop over
//          [x[t-d] | x[t] | x[t+d] | spect[t]] (K = 3C + M), block j owns
//          slab j;
//   stream is the TPU's one-step-behind walk: the grid has one block more
//          than there are slabs and block s owns slab s - 1 (block 0, the
//          TPU's ring-filling step, has nothing left to do: the left halo
//          that the two-slot VMEM ring carried comes from global memory,
//          because CUDA blocks do not run in order).  Its K loop runs in
//          the ring window's order: the conditioning, then the middle tap,
//          the left halo and the look-ahead.
//
// What bounds them on an H100: operations.  At B=1, T=6400, C=512, M=640
// one spect layer is 2 x 6400 x (2176 x 1024 + 512 x 1024) = 35.2 GFLOP,
// 0.036 ms at the bf16 tensor-core peak against 10 MB of traffic.  These
// kernels do their products on the f32 FMA units (67 TFLOP/s at most, 0.53
// ms); they are oracles and speed is not their aim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 32;     // rows per block
constexpr int THREADS = 128;  // 8 row groups of 4 x 16 column groups
constexpr int KT = 32;        // K per staged tile
constexpr int NC = 64;        // GEMM columns per chunk
constexpr int PAIRS = NC / 2;  // gate pairs per in_act chunk
constexpr int A_LD = KT + 1;
constexpr int MAX_E = 8;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

struct Slab {
  float* A;  // [ROWS][A_LD]  staged K tile of the rows
  float* W;  // staged K tile of the weights: [KT][NC] (padded, spect) or
             // [NC][A_LD], transposed (stream, stream final)
  bf16* G;   // [ROWS][C + 2] gated activations
  bf16* S;   // [ROWS][C + 2] final layer: bf16(skip_acc + rs)
};

__device__ __forceinline__ Slab carve(void* smem, int C) {
  Slab s;
  s.A = reinterpret_cast<float*>(smem);
  s.W = s.A + ROWS * A_LD;
  s.G = reinterpret_cast<bf16*>(s.W + NC * A_LD);
  s.S = s.G + ROWS * (C + 2);
  return s;
}

// --- the padded and spect kernels' GEMMs, gate and epilogue ---------------
// Thread map: 8 row groups of 4 rows x 16 column groups.

// acc_t / acc_s += A[rows, KT] @ W[KT, tanh / sigmoid columns of the
// thread's two pairs]
__device__ __forceinline__ void fma_pairs(const Slab& s, float acc_t[4][2],
                                          float acc_s[4][2]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 8
  for (int kk = 0; kk < KT; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s.A[(tr * 4 + i) * A_LD + kk];
    const float2 wt = *reinterpret_cast<const float2*>(&s.W[kk * NC + 2 * tc]);
    const float2 ws =
        *reinterpret_cast<const float2*>(&s.W[kk * NC + PAIRS + 2 * tc]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc_t[i][0] += a[i] * wt.x;
      acc_t[i][1] += a[i] * wt.y;
      acc_s[i][0] += a[i] * ws.x;
      acc_s[i][1] += a[i] * ws.y;
    }
  }
}

// One staged K tile: A[r][kk] = rows[(t0 + r + shift) * ld + k0 + kk] and
// W[kk][col] = w[(k0 + kk) * 2C + gate column of col in chunk c0].
__device__ __forceinline__ void stage_pairs(const Slab& s, const bf16* rows,
                                            int row_ld, int t0, int shift,
                                            int k0, const bf16* w, int C,
                                            int c0) {
  for (int idx = threadIdx.x; idx < ROWS * KT; idx += THREADS) {
    const int r = idx / KT, kk = idx % KT;
    s.A[r * A_LD + kk] = ld(rows + (size_t)(t0 + r + shift) * row_ld + k0 + kk);
  }
  for (int idx = threadIdx.x; idx < KT * NC; idx += THREADS) {
    const int kk = idx / NC, col = idx % NC;
    const int gcol = col < PAIRS ? c0 + col : C + c0 + col - PAIRS;
    s.W[kk * NC + col] = ld(w + (size_t)(k0 + kk) * 2 * C + gcol);
  }
}

// gated slab, columns c0 + 2 tc + q: bf16(tanh(pre_t) sigmoid(pre_s))
__device__ __forceinline__ void store_gate(const Slab& s, int C, int c0,
                                           const float pre_t[4][2],
                                           const float pre_s[4][2]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      s.G[(tr * 4 + i) * (C + 2) + c0 + 2 * tc + q] =
          __float2bfloat16(tanhf(pre_t[i][q]) * sigmoid_f(pre_s[i][q]));
}

// acc = G[rows, C] @ w_rs[:, n0 : n0 + NC], 4 rows x 4 columns per thread
__device__ void rs_chunk(const Slab& s, const bf16* w_rs, int C, int rs_out,
                         int n0, float acc[4][4]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KT * NC; idx += THREADS) {
      const int kk = idx / NC, col = idx % NC;
      s.W[kk * NC + col] = ld(w_rs + (size_t)(k0 + kk) * rs_out + n0 + col);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(&s.W[kk * NC + 4 * tc]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = __bfloat162float(s.G[(tr * 4 + i) * (C + 2) + k0 + kk]);
        acc[i][0] += a * w.x;
        acc[i][1] += a * w.y;
        acc[i][2] += a * w.z;
        acc[i][3] += a * w.w;
      }
    }
  }
}

// Res/skip epilogue of the padded, spect and stream kernels.  skip_acc may
// be null (padded: skip returned as it is) or equal to skip_out (in place).
__device__ void rs_store(const Slab& s, const bf16* x, const bf16* w_rs,
                         const float* b_rs, const bf16* skip_acc,
                         bf16* x_out, bf16* skip_out, int b, int Tp, int bt,
                         int n_valid, int C, int rs_out, int t0) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const bool has_res = rs_out == 2 * C;
  for (int n0 = 0; n0 < rs_out; n0 += NC) {
    float acc[4][4];
    rs_chunk(s, w_rs, C, rs_out, n0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tr * 4 + i;
      const size_t row = (size_t)b * Tp + t;
      const bool valid = t - bt < n_valid;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 4 * tc + j;
        const float v = acc[i][j] + b_rs[col];
        if (has_res && col < C) {
          x_out[row * C + col] = __float2bfloat16(
              valid ? ld(x + row * C + col) + v : 0.f);
        } else {
          const size_t o = row * C + (has_res ? col - C : col);
          const bf16 sk = __float2bfloat16(v);
          skip_out[o] = skip_acc == nullptr
                            ? sk
                            : __float2bfloat16(ld(skip_acc + o) +
                                               __bfloat162float(sk));
        }
      }
    }
  }
  if (!has_res) {  // the hidden state passes through, masked
    for (int idx = threadIdx.x; idx < ROWS * C; idx += THREADS) {
      const int r = idx / C, c = idx % C, t = t0 + r;
      const size_t o = ((size_t)b * Tp + t) * C + c;
      x_out[o] = t - bt < n_valid ? x[o] : __float2bfloat16(0.f);
    }
  }
}

__device__ void zero_rows(bf16* p, int b, int Tp, int width, int t0) {
  if (p == nullptr) return;
  bf16* base = p + ((size_t)b * Tp + t0) * width;
  for (int idx = threadIdx.x; idx < ROWS * width; idx += THREADS)
    base[idx] = __float2bfloat16(0.f);
}

__device__ __forceinline__ bool in_pad(int t0, int Tp, int bt) {
  return t0 < bt || t0 >= Tp - bt;  // bt % ROWS == 0: a slab is all pad or none
}

// --- kernel 12: pre-materialized conditioning, skip not accumulated -------
__global__ void __launch_bounds__(THREADS)
    wn_padded_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cond,
                     const bf16* __restrict__ w_in,
                     const float* __restrict__ b_in,
                     const bf16* __restrict__ w_rs,
                     const float* __restrict__ b_rs, bf16* __restrict__ x_out,
                     bf16* __restrict__ skip_out, int Tp, int bt, int n_valid,
                     int C, int cond_ld, int cond_off, int rs_out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slab s = carve(smem, C);
  const int b = blockIdx.y, t0 = blockIdx.x * ROWS;
  if (in_pad(t0, Tp, bt)) {
    zero_rows(x_out, b, Tp, C, t0);
    zero_rows(skip_out, b, Tp, C, t0);
    return;
  }
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const bf16* xb = x + (size_t)b * Tp * C;
  for (int c0 = 0; c0 < C; c0 += PAIRS) {
    float at[4][2] = {}, as[4][2] = {};
    for (int k0 = 0; k0 < 3 * C; k0 += KT) {
      const int tap = k0 / C;
      __syncthreads();
      stage_pairs(s, xb, C, t0, (tap - 1) * d, k0 - tap * C,
                  w_in + (size_t)tap * C * 2 * C, C, c0);
      __syncthreads();
      fma_pairs(s, at, as);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16* cr = cond + ((size_t)b * Tp + t0 + tr * 4 + i) * cond_ld +
                       cond_off;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = c0 + 2 * tc + q;
        at[i][q] += b_in[col] + ld(cr + col);
        as[i][q] += b_in[C + col] + ld(cr + C + col);
      }
    }
    store_gate(s, C, c0, at, as);
  }
  rs_store(s, x, w_rs, b_rs, nullptr, x_out, skip_out, b, Tp, bt, n_valid, C,
           rs_out, t0);
}

// --- kernel 13: in-kernel conditioning, skip summed in place --------------
// One flat K loop over [x[t-d] | x[t] | x[t+d] | spect[t]].
__global__ void __launch_bounds__(THREADS)
    wn_spect_kernel(const bf16* __restrict__ x, const bf16* __restrict__ spect,
                    const bf16* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const bf16* __restrict__ w_cond,
                    const float* __restrict__ b_cond,
                    const bf16* __restrict__ w_rs,
                    const float* __restrict__ b_rs, bf16* skip,
                    bf16* __restrict__ x_out, int Tp, int bt, int n_valid,
                    int C, int M, int rs_out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slab s = carve(smem, C);
  const int b = blockIdx.y, t0 = blockIdx.x * ROWS;
  if (in_pad(t0, Tp, bt)) {
    zero_rows(x_out, b, Tp, C, t0);
    zero_rows(skip, b, Tp, C, t0);
    return;
  }
  const int tc = threadIdx.x & 15;
  const bf16* xb = x + (size_t)b * Tp * C;
  const bf16* sb = spect + (size_t)b * Tp * M;
  for (int c0 = 0; c0 < C; c0 += PAIRS) {
    float at[4][2] = {}, as[4][2] = {};
    for (int k0 = 0; k0 < 3 * C + M; k0 += KT) {
      __syncthreads();
      if (k0 < 3 * C) {
        const int tap = k0 / C;
        stage_pairs(s, xb, C, t0, (tap - 1) * d, k0 - tap * C,
                    w_in + (size_t)tap * C * 2 * C, C, c0);
      } else {
        stage_pairs(s, sb, M, t0, 0, k0 - 3 * C, w_cond, C, c0);
      }
      __syncthreads();
      fma_pairs(s, at, as);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = c0 + 2 * tc + q;
        at[i][q] += b_in[col] + b_cond[col];
        as[i][q] += b_in[C + col] + b_cond[C + col];
      }
    store_gate(s, C, c0, at, as);
  }
  rs_store(s, x, w_rs, b_rs, skip, x_out, skip, b, Tp, bt, n_valid, C,
           rs_out, t0);
}

// --- the stream kernels' GEMMs, gate and epilogue ---------------------------
// Kernels 14 and 15 share none of the code above but the layout helpers, so
// that the ladder's 13 <-> 14 rung compares two implementations of one
// contract: another thread map (one row and eight gate pairs, or sixteen
// res/skip columns, per thread), the weights staged transposed, their own
// gate and their own res/skip epilogue.

__device__ __forceinline__ int srow() { return threadIdx.x >> 2; }  // 0..31
__device__ __forceinline__ int squad() { return threadIdx.x & 3; }  // 0..3

// A[r][kk] = rows[(t0 + r + shift) * row_ld + k0 + kk]
__device__ void stream_stage_rows(const Slab& s, const bf16* rows, int row_ld,
                                  int t0, int shift, int k0) {
  for (int idx = threadIdx.x; idx < ROWS * KT; idx += THREADS) {
    const int r = idx / KT, kk = idx % KT;
    s.A[r * A_LD + kk] = ld(rows + (size_t)(t0 + r + shift) * row_ld + k0 + kk);
  }
}

// W[col][kk] = w[(k0 + kk) * w_ld + n0 + col]; with pair_c = C (in_act)
// columns PAIRS.. of the tile are the sigmoid partners C + n0 + col - PAIRS
__device__ void stream_stage_w(const Slab& s, const bf16* w, int w_ld, int k0,
                               int n0, int pair_c) {
  for (int idx = threadIdx.x; idx < KT * NC; idx += THREADS) {
    const int kk = idx / NC, col = idx % NC;
    const int gcol = pair_c > 0 && col >= PAIRS ? pair_c + n0 + col - PAIRS
                                                : n0 + col;
    s.W[col * A_LD + kk] = ld(w + (size_t)(k0 + kk) * w_ld + gcol);
  }
}

// in_act of the slab at t0 in the ring window's order (conditioning, then
// the middle tap, the left halo t - d and the look-ahead t + d), gated
// into G
__device__ void stream_in_act(const Slab& s, const bf16* xb, const bf16* sb,
                              const bf16* w_in, const float* b_in,
                              const bf16* w_cond, const float* b_cond, int C,
                              int M, int d, int t0) {
  const int r = srow(), q = squad();
  for (int c0 = 0; c0 < C; c0 += PAIRS) {
    float at[8] = {}, as[8] = {};
    for (int pass = 0; pass < 4; ++pass) {
      // pass 0: conditioning (tap -1); then taps 1 (t), 0 (t - d), 2 (t + d)
      const int tap = pass == 0 ? -1 : pass == 1 ? 1 : pass == 2 ? 0 : 2;
      const int K = tap < 0 ? M : C;
      for (int k0 = 0; k0 < K; k0 += KT) {
        __syncthreads();
        if (tap < 0) {
          stream_stage_rows(s, sb, M, t0, 0, k0);
          stream_stage_w(s, w_cond, 2 * C, k0, c0, C);
        } else {
          stream_stage_rows(s, xb, C, t0, (tap - 1) * d, k0);
          stream_stage_w(s, w_in + (size_t)tap * C * 2 * C, 2 * C, k0, c0, C);
        }
        __syncthreads();
        for (int kk = 0; kk < KT; ++kk) {
          const float a = s.A[r * A_LD + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            at[j] += a * s.W[(q * 8 + j) * A_LD + kk];
            as[j] += a * s.W[(PAIRS + q * 8 + j) * A_LD + kk];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + q * 8 + j;
      const float pt = at[j] + (b_cond[col] + b_in[col]);
      const float ps = as[j] + (b_cond[C + col] + b_in[C + col]);
      s.G[r * (C + 2) + col] = __float2bfloat16(tanhf(pt) / (1.f + expf(-ps)));
    }
  }
}

// acc[j] = G[row srow(), :C] @ w_rs[:, n0 + 16 squad() + j]
__device__ void stream_rs_chunk(const Slab& s, const bf16* w_rs, int C,
                                int rs_out, int n0, float acc[16]) {
  const int r = srow(), q = squad();
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KT) {
    __syncthreads();
    stream_stage_w(s, w_rs, rs_out, k0, n0, 0);
    __syncthreads();
    for (int kk = 0; kk < KT; ++kk) {
      const float g = __bfloat162float(s.G[r * (C + 2) + k0 + kk]);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += g * s.W[(q * 16 + j) * A_LD + kk];
    }
  }
}

// kernel 14's res/skip epilogue: x_out = x + rs[:C] (x itself when w_rs is
// [C, C]), zero past n_valid; skip += rs[C:] (or rs) in place, unmasked
__device__ void stream_rs_store(const Slab& s, const bf16* x,
                                const bf16* w_rs, const float* b_rs,
                                bf16* skip, bf16* x_out, int b, int Tp,
                                int bt, int n_valid, int C, int rs_out,
                                int t0) {
  const int r = srow(), q = squad(), t = t0 + r;
  const size_t row = ((size_t)b * Tp + t) * C;
  const bool keep = t - bt < n_valid;
  const int res = rs_out == 2 * C ? C : 0;  // res columns ahead of skip's
  if (res == 0)
    for (int c = q; c < C; c += 4)
      x_out[row + c] = keep ? x[row + c] : __float2bfloat16(0.f);
  for (int n0 = 0; n0 < rs_out; n0 += NC) {
    float acc[16];
    stream_rs_chunk(s, w_rs, C, rs_out, n0, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + q * 16 + j;
      const float v = acc[j] + b_rs[col];
      if (col < res) {
        x_out[row + col] =
            keep ? __float2bfloat16(__bfloat162float(x[row + col]) + v)
                 : __float2bfloat16(0.f);
      } else {
        bf16* o = skip + row + (col - res);
        *o = __float2bfloat16(__bfloat162float(*o) +
                              __bfloat162float(__float2bfloat16(v)));
      }
    }
  }
}

// --- kernel 14: the one-step-behind walk, skip summed in place ------------
__global__ void __launch_bounds__(THREADS)
    wn_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ spect,
                     const bf16* __restrict__ w_in,
                     const float* __restrict__ b_in,
                     const bf16* __restrict__ w_cond,
                     const float* __restrict__ b_cond,
                     const bf16* __restrict__ w_rs,
                     const float* __restrict__ b_rs, bf16* skip,
                     bf16* __restrict__ x_out, int Tp, int bt, int n_valid,
                     int C, int M, int rs_out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0) return;  // the TPU's ring-filling step
  const Slab s = carve(smem, C);
  const int b = blockIdx.y, t0 = (blockIdx.x - 1) * ROWS;
  if (in_pad(t0, Tp, bt)) {
    zero_rows(x_out, b, Tp, C, t0);
    zero_rows(skip, b, Tp, C, t0);
    return;
  }
  stream_in_act(s, x + (size_t)b * Tp * C, spect + (size_t)b * Tp * M, w_in,
                b_in, w_cond, b_cond, C, M, d, t0);
  stream_rs_store(s, x, w_rs, b_rs, skip, x_out, b, Tp, bt, n_valid, C,
                  rs_out, t0);
}

// --- kernel 15: the last layer with the end projection folded in ---------
__global__ void __launch_bounds__(THREADS) wn_stream_final_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ spect,
    const bf16* __restrict__ w_in, const float* __restrict__ b_in,
    const bf16* __restrict__ w_cond, const float* __restrict__ b_cond,
    const bf16* __restrict__ w_rs, const float* __restrict__ b_rs,
    const bf16* __restrict__ skip_acc, const bf16* __restrict__ w_end,
    const float* __restrict__ b_end, float* __restrict__ out, int Tp, int bt,
    int C, int M, int E, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0) return;
  const Slab s = carve(smem, C);
  const int b = blockIdx.y, t0 = (blockIdx.x - 1) * ROWS;
  float* ob = out + ((size_t)b * Tp + t0) * E;
  if (in_pad(t0, Tp, bt)) {
    for (int idx = threadIdx.x; idx < ROWS * E; idx += THREADS) ob[idx] = 0.f;
    return;
  }
  stream_in_act(s, x + (size_t)b * Tp * C, spect + (size_t)b * Tp * M, w_in,
                b_in, w_cond, b_cond, C, M, d, t0);
  const int r = srow(), q = squad();
  const bf16* ar = skip_acc + ((size_t)b * Tp + t0 + r) * C;
  for (int n0 = 0; n0 < C; n0 += NC) {
    float acc[16];
    stream_rs_chunk(s, w_rs, C, C, n0, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + q * 16 + j;
      s.S[r * (C + 2) + col] =
          __float2bfloat16(ld(ar + col) + (acc[j] + b_rs[col]));
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * E; idx += THREADS) {
    const int row = idx / E, e = idx % E;
    float sum = 0.f;
    for (int c = 0; c < C; ++c)
      sum += __bfloat162float(s.S[row * (C + 2) + c]) *
             ld(w_end + (size_t)c * E + e);
    ob[idx] = sum + b_end[e];
  }
}

size_t smem_bytes(int C, bool final_layer) {
  return sizeof(float) * (ROWS + NC) * A_LD +
         sizeof(bf16) * ROWS * (C + 2) * (final_layer ? 2 : 1);
}

bool bad_dims(int B, int Tp, int bt, int C, int M, int d) {
  return B <= 0 || bt <= 0 || bt % ROWS || Tp % bt || Tp < 3 * bt ||
         C <= 0 || C % NC || M < 0 || M % KT || d < 0 || d > bt;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Plain C interface (loaded with ctypes).  bf16 activations and weights,
// f32 biases, all dense; w_in [3, C, 2C], w_cond [M, 2C], w_rs [C, rs_out]
// with rs_out = 2C or C, w_end [C, E <= 8].  Tp = T + 2 bt with bt % 32 ==
// 0 and d <= bt; C % 64 == 0, M % 32 == 0.  The shapes are checked by the
// Python wrappers (ops/wn_block_padded.py).  Each returns
// cudaGetLastError() after its launch.
extern "C" {

int t2s_wn_padded(const void* x, const void* cond, const void* w_in,
                  const void* b_in, const void* w_rs, const void* b_rs,
                  void* x_out, void* skip_out, int B, int Tp, int bt,
                  int n_valid, int C, int n_cond, int cond_index, int rs_out,
                  int d, void* stream) {
  if (bad_dims(B, Tp, bt, C, 0, d) || n_cond <= 0 || cond_index < 0 ||
      cond_index >= n_cond || (rs_out != C && rs_out != 2 * C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, false);
  int err = prepare(wn_padded_kernel, smem);
  if (err) return err;
  wn_padded_kernel<<<dim3(Tp / ROWS, B), THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)cond, (const bf16*)w_in,
      (const float*)b_in, (const bf16*)w_rs, (const float*)b_rs,
      (bf16*)x_out, (bf16*)skip_out, Tp, bt, n_valid, C, 2 * C * n_cond,
      2 * C * cond_index, rs_out, d);
  return (int)cudaGetLastError();
}

int t2s_wn_spect(const void* x, const void* spect, const void* w_in,
                 const void* b_in, const void* w_cond, const void* b_cond,
                 const void* w_rs, const void* b_rs, void* skip, void* x_out,
                 int B, int Tp, int bt, int n_valid, int C, int M, int rs_out,
                 int d, void* stream) {
  if (bad_dims(B, Tp, bt, C, M, d) || M == 0 ||
      (rs_out != C && rs_out != 2 * C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, false);
  int err = prepare(wn_spect_kernel, smem);
  if (err) return err;
  wn_spect_kernel<<<dim3(Tp / ROWS, B), THREADS, smem,
                    (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)spect, (const bf16*)w_in,
      (const float*)b_in, (const bf16*)w_cond, (const float*)b_cond,
      (const bf16*)w_rs, (const float*)b_rs, (bf16*)skip, (bf16*)x_out, Tp,
      bt, n_valid, C, M, rs_out, d);
  return (int)cudaGetLastError();
}

int t2s_wn_stream(const void* x, const void* spect, const void* w_in,
                  const void* b_in, const void* w_cond, const void* b_cond,
                  const void* w_rs, const void* b_rs, void* skip, void* x_out,
                  int B, int Tp, int bt, int n_valid, int C, int M, int rs_out,
                  int d, void* stream) {
  if (bad_dims(B, Tp, bt, C, M, d) || M == 0 ||
      (rs_out != C && rs_out != 2 * C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, false);
  int err = prepare(wn_stream_kernel, smem);
  if (err) return err;
  wn_stream_kernel<<<dim3(Tp / ROWS + 1, B), THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)spect, (const bf16*)w_in,
      (const float*)b_in, (const bf16*)w_cond, (const float*)b_cond,
      (const bf16*)w_rs, (const float*)b_rs, (bf16*)skip, (bf16*)x_out, Tp,
      bt, n_valid, C, M, rs_out, d);
  return (int)cudaGetLastError();
}

int t2s_wn_stream_final(const void* x, const void* spect, const void* w_in,
                        const void* b_in, const void* w_cond,
                        const void* b_cond, const void* w_rs,
                        const void* b_rs, const void* skip_acc,
                        const void* w_end, const void* b_end, void* out,
                        int B, int Tp, int bt, int C, int M, int E, int d,
                        void* stream) {
  if (bad_dims(B, Tp, bt, C, M, d) || M == 0 || E < 1 || E > MAX_E)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, true);
  int err = prepare(wn_stream_final_kernel, smem);
  if (err) return err;
  wn_stream_final_kernel<<<dim3(Tp / ROWS + 1, B), THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)spect, (const bf16*)w_in,
      (const float*)b_in, (const bf16*)w_cond, (const float*)b_cond,
      (const bf16*)w_rs, (const float*)b_rs, (const bf16*)skip_acc,
      (const bf16*)w_end, (const float*)b_end, (float*)out, Tp, bt, C, M, E,
      d);
  return (int)cudaGetLastError();
}

}  // extern "C"
