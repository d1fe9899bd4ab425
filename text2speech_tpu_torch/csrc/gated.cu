// WaveGlow gated activation, forward and backward, hand-written for Hopper
// (sm_90a).
//
//   forward   replaces text2speech_tpu/ops/pallas/gated.py:64 _pallas_fwd
//             (body _fwd_kernel, :32; custom_vjp gated_activation_pallas, :90)
//   backward  replaces text2speech_tpu/ops/pallas/gated.py:76 _pallas_bwd
//             (body _bwd_kernel, :41)
//
// For rows r of a [rows, 2C] pair (a, b), in the IO type T (f32 or bf16):
//
//   x        = T(a + b)                      the sum, rounded as T rounds it
//   out[r]   = T( tanh(x[:C]) * sigmoid(x[C:]) )                 [C], f32 math
//   dx[r]    = T( [ g (1 - t^2) s,  g t s (1 - s) ] )            [2C]
//              with t = tanh(x[:C]), s = sigmoid(x[C:]) recomputed from a, b
//
// The sum is never stored: the backward reads a, b and the cotangent g and
// writes ONE dx, which is the gradient of both inputs.
//
// Design.  The TPU kernel walks [256, 2C] VMEM tiles over a (B, T / 256)
// grid.  Here there is nothing to tile: each thread owns 16 bytes of the
// output row (4 f32 or 8 bf16 columns c) and loads the matching 16 bytes at
// columns c and c + C of a and b, in a grid-stride loop over rows x C / VEC.
// a, b and g are addressed by a row stride given as an argument, so the
// conditioning can be a column slice of the fused [rows, 2C * L] projection
// (row stride 2C * L) with no copy; out and dx are dense.  When a pointer,
// a stride or C does not allow 16-byte accesses the same kernel runs with
// VEC = 1.
//
// What bounds it on an H100: bytes.  Forward moves 5C elements per row,
// backward 7C, against ~40 f32 operations per output element; at 3.35 TB/s
// the [6000, 1024] f32 forward cannot take less than 0.018 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float& o, float v) { o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& o, float v) {
  o = __float2bfloat16(v);
}

// a + b rounded to T, then widened: bf16 inputs sum as a bf16 add does.
template <typename T>
__device__ __forceinline__ float sum_as(T a, T b) {
  T s;
  from_f32(s, to_f32(a) + to_f32(b));
  return to_f32(s);
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    gated_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ out, long long rows, int C, long long sa,
                     long long sb) {
  const int cv = C / VEC;
  const long long n = rows * cv;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long r = i / cv;
    const int c = (int)(i - r * cv) * VEC;
    const T* ar = a + r * sa + c;
    const T* br = b + r * sb + c;
    const Pack<T, VEC> at = load<T, VEC>(ar), as = load<T, VEC>(ar + C);
    const Pack<T, VEC> bt = load<T, VEC>(br), bs = load<T, VEC>(br + C);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      from_f32(o.v[e], tanhf(sum_as(at.v[e], bt.v[e])) *
                           sigmoid_f32(sum_as(as.v[e], bs.v[e])));
    *reinterpret_cast<Pack<T, VEC>*>(out + r * C + c) = o;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    gated_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ g, T* __restrict__ dx,
                     long long rows, int C, long long sa, long long sb,
                     long long sg) {
  const int cv = C / VEC;
  const long long n = rows * cv;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long r = i / cv;
    const int c = (int)(i - r * cv) * VEC;
    const T* ar = a + r * sa + c;
    const T* br = b + r * sb + c;
    const Pack<T, VEC> at = load<T, VEC>(ar), as = load<T, VEC>(ar + C);
    const Pack<T, VEC> bt = load<T, VEC>(br), bs = load<T, VEC>(br + C);
    const Pack<T, VEC> gv = load<T, VEC>(g + r * sg + c);
    Pack<T, VEC> du, dv;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float t = tanhf(sum_as(at.v[e], bt.v[e]));
      const float s = sigmoid_f32(sum_as(as.v[e], bs.v[e]));
      const float gf = to_f32(gv.v[e]);
      from_f32(du.v[e], gf * (1.f - t * t) * s);
      from_f32(dv.v[e], gf * t * s * (1.f - s));
    }
    T* o = dx + r * 2 * C + c;
    *reinterpret_cast<Pack<T, VEC>*>(o) = du;
    *reinterpret_cast<Pack<T, VEC>*>(o + C) = dv;
  }
}

int blocks_for(long long rows, int C, int vec) {
  const long long n = rows * (C / vec);
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

template <typename T, int VEC>
int launch_fwd(const void* a, const void* b, void* out, long long rows, int C,
               long long sa, long long sb, void* stream) {
  gated_fwd_kernel<T, VEC>
      <<<blocks_for(rows, C, VEC), THREADS, 0, (cudaStream_t)stream>>>(
          (const T*)a, (const T*)b, (T*)out, rows, C, sa, sb);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const void* a, const void* b, const void* g, void* dx,
               long long rows, int C, long long sa, long long sb,
               long long sg, void* stream) {
  gated_bwd_kernel<T, VEC>
      <<<blocks_for(rows, C, VEC), THREADS, 0, (cudaStream_t)stream>>>(
          (const T*)a, (const T*)b, (const T*)g, (T*)dx, rows, C, sa, sb, sg);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Row strides are in elements.
// `is_bf16` picks the IO type; `vec` says that every pointer and row stride
// is 16-byte aligned and C is a multiple of 16 / sizeof(T) (checked by the
// Python wrapper).  Each returns cudaGetLastError() after the launch.
extern "C" {

int t2s_gated_fwd(const void* a, const void* b, void* out, long long rows,
                  int C, long long sa, long long sb, int is_bf16, int vec,
                  void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return vec ? launch_fwd<__nv_bfloat16, 8>(a, b, out, rows, C, sa, sb, stream)
               : launch_fwd<__nv_bfloat16, 1>(a, b, out, rows, C, sa, sb, stream);
  return vec ? launch_fwd<float, 4>(a, b, out, rows, C, sa, sb, stream)
             : launch_fwd<float, 1>(a, b, out, rows, C, sa, sb, stream);
}

int t2s_gated_bwd(const void* a, const void* b, const void* g, void* dx,
                  long long rows, int C, long long sa, long long sb,
                  long long sg, int is_bf16, int vec, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return vec ? launch_bwd<__nv_bfloat16, 8>(a, b, g, dx, rows, C, sa, sb, sg,
                                              stream)
               : launch_bwd<__nv_bfloat16, 1>(a, b, g, dx, rows, C, sa, sb, sg,
                                              stream);
  return vec ? launch_bwd<float, 4>(a, b, g, dx, rows, C, sa, sb, sg, stream)
             : launch_bwd<float, 1>(a, b, g, dx, rows, C, sa, sb, sg, stream);
}

}  // extern "C"
