// fed_agg: K-way weighted aggregation, out[n] = sum_k w[k] * x[k, n].
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_agg/kernel.py:fed_agg_2d
// (body _fed_agg_kernel).  x is (K, N) row-major, fp32 or bf16; w is (K,)
// fp32; the sum accumulates in fp32 in k order and is written in x's dtype
// (round-to-nearest-even for bf16, as torch's .to(bfloat16)).  Each product
// and each sum is rounded on its own (__fmul_rn / __fadd_rn: no fused
// multiply-add), so the kernel equals the plain version (ref.py) and the
// reference's core.aggregation.weighted_average bit for bit.
//
// Bound: device-memory bytes.  Each x element is read once and each output
// written once, (K+1)*N*itemsize bytes, for 2*K*N flops -- far below the
// card's flop/byte balance.  The design therefore only has to stream: one
// thread owns VEC = 16 / itemsize contiguous outputs (4 fp32 or 8 bf16),
// reads them with one 16-byte load per row, and loops over K with the
// accumulators in registers (w is read through the read-only cache, the
// same address for every thread).  Rows are 16-byte aligned only when
// N % VEC == 0; otherwise (vec_ok == 0) each thread reads its VEC elements
// one by one, and the ragged tail is masked in both cases -- nothing is
// padded (the Pallas kernel pads N up to its 2048-wide tile).
//
// At the main path's size (K <= 5, N = 20,490 for flight-cnn-mnist, about
// 0.5 MB moved) the kernel is bound by launch latency, not bandwidth.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void fed_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ out, int K, int64_t N, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (i0 >= N) return;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;

  if (vec_ok) {  // N % VEC == 0 and 16-byte aligned rows: every thread is whole
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(w + k);
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + k * N + i0));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_f32(v[j])));
    }
    alignas(16) T o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(o);
    return;
  }

  const int n = static_cast<int>(N - i0 < VEC ? N - i0 : VEC);  // ragged tail
  for (int k = 0; k < K; ++k) {
    const float wk = __ldg(w + k);
    const T* xk = x + k * N + i0;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < n) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_f32(xk[j])));
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < n) out[i0 + j] = from_f32<T>(acc[j]);
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* out, int K, int64_t N,
                   int vec_ok, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int THREADS = 256;
  const int64_t items = (N + VEC - 1) / VEC;
  const int64_t blocks = (items + THREADS - 1) / THREADS;
  fed_agg_kernel<T><<<static_cast<unsigned int>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), K, N, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
int fed_agg_launch(const void* x, const void* w, void* out, int K, int64_t N,
                   int dtype, int vec_ok, void* stream) {
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, wf, out, K, N, vec_ok, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, wf, out, K, N, vec_ok, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fed_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
