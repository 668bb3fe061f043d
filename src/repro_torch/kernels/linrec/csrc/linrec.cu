// linrec: the diagonal first-order linear recurrence
//
//   h_t = a_t * h_{t-1} + b_t,     h_{-1} = h0 (zeros when not given)
//
// over the time axis of (B, T, D) inputs, fp32 or bf16, with fp32
// arithmetic and an fp32 (B, T, D) output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec/kernel.py:
// linrec_btd (body _linrec_kernel), which starts from a zero carry, and,
// with a starting state h0, the models' scan
// src/repro/models/ssm.py:_chunked_linear_scan (the mamba selective scan
// with D = d_inner * N, and the RG-LRU of models/rglru.py with D =
// lru_width), which the JAX package runs as an associative scan.  Each
// step is a product and a sum, each rounded on its own (__fmul_rn /
// __fadd_rn, no fused multiply-add), so the kernel equals the plain
// version (ref.py), which runs the same loop as PyTorch ops, bit for bit.
// It differs from the JAX scans only in the order of the sums.
//
// Bound on the H100: device-memory bytes.  Every element of a and b is
// read once and every h written once, 12 bytes an element for fp32 inputs
// and 2 operations: falcon-mamba-7b's prefill scan at 4 x 2,048 tokens
// (D = 8,192 x 16 = 131,072) moves 12.9 GB, 3.85 ms at 3.35 TB/s.
//
// Design: one thread owns one (b, d) column and walks T with h in a
// register.  Neighbouring threads take neighbouring d, so each warp's load
// of a time step is one contiguous 128-byte line (64 bytes in bf16).  The
// loads of a and b do not depend on h: UNROLL time steps of both are
// issued together before the dependent chain of products and sums, so
// each warp keeps 2 * UNROLL loads in flight.  At falcon's width the grid
// holds 524,288 columns, enough warps to cover the memory latency.  At a
// narrow shape (recurrentgemma-9b: B * D = 8,192 columns, about 4 % of the
// card's thread slots) too few loads are in flight and the kernel runs
// well below its bound; splitting T into chunks (the Pallas kernel's two
// levels: per-chunk composites, a carry pass, a re-run) is the redesign
// for that.  The TPU kernel's in-tile log-depth doubling is a device for
// the TPU's vector unit and is not carried over.
//
// Layout: a and b may be strided views along batch and time (the wrapper
// passes those strides); d must be contiguous.  h0, when given, is a
// contiguous (B, D) fp32 tensor; out is a fresh contiguous (B, T, D) fp32
// tensor.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  // bf16 -> fp32 is exact: the 16 bits are the top half of the fp32 word
  const unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(raw) << 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linrec_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ h0, float* __restrict__ out,
              int64_t B, int64_t T_len, int64_t D,
              int64_t sa_b, int64_t sa_t, int64_t sb_b, int64_t sb_t) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (col >= B * D) return;
  const int64_t bi = col / D;
  const int64_t d = col - bi * D;
  const T* pa = a + bi * sa_b + d;
  const T* pb = b + bi * sb_b + d;
  float* po = out + bi * T_len * D + d;
  float h = h0 != nullptr ? h0[col] : 0.0f;   // h0 is (B, D): its index is col

  int64_t t = 0;
  for (; t + UNROLL <= T_len; t += UNROLL) {
    float ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      ra[j] = load_f32(pa + j * sa_t);
      rb[j] = load_f32(pb + j * sb_t);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      h = __fadd_rn(__fmul_rn(ra[j], h), rb[j]);
      po[j * D] = h;
    }
    pa += UNROLL * sa_t;
    pb += UNROLL * sb_t;
    po += UNROLL * D;
  }
  for (; t < T_len; ++t) {   // the last T % UNROLL steps
    h = __fadd_rn(__fmul_rn(load_f32(pa), h), load_f32(pb));
    *po = h;
    pa += sa_t;
    pb += sb_t;
    po += D;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* out,
                   int64_t B, int64_t T_len, int64_t D, int64_t sa_b,
                   int64_t sa_t, int64_t sb_b, int64_t sb_t,
                   cudaStream_t stream) {
  const int64_t blocks = (B * D + THREADS - 1) / THREADS;
  linrec_kernel<T><<<static_cast<unsigned int>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, out, B, T_len, D,
      sa_b, sa_t, sb_b, sb_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a and b).  h0 may be null (zeros).
// Strides are in elements.  Returns the cudaError_t of the launch.
int linrec_launch(const void* a, const void* b, const void* h0, void* out,
                  int64_t B, int64_t T_len, int64_t D, int64_t sa_b,
                  int64_t sa_t, int64_t sb_b, int64_t sb_t, int dtype,
                  void* stream) {
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, b, h, o, B, T_len, D, sa_b, sa_t,
                                          sb_b, sb_t, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a, b, h, o, B, T_len, D, sa_b,
                                                   sa_t, sb_b, sb_t, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* linrec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
