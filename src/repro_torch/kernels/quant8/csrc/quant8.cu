// quant8: symmetric int8 quantisation with one fp32 scale per row, and its
// inverse.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant8/kernel.py:
// quantize_blocked (body _quant_kernel) and dequantize_blocked (body
// _dequant_kernel).  For x (R, C) row-major, fp32 or bf16 (converted to fp32
// on load), per row:
//
//   scale = amax(|x|) / 127,  q = clip(rint(x / max(scale, 1e-12)), -127, 127)
//
// and the inverse out = float(q) * scale, written in fp32 or bf16 (round to
// nearest even, as torch's .to(bfloat16)).  The arithmetic is the plain
// version's (ref.py) and the reference's core.compression._symmetric_q8
// exactly: both divisions are IEEE (__fdiv_rn, never a reciprocal), the
// rounding is rintf (half to even, like torch.round and jnp.round), and the
// library is built without --use_fast_math.  So q and scales are bit-equal.
//
// Non-finite rows follow the reference too.  CUDA's fmaxf/fminf drop a NaN
// operand, which would give a NaN row a finite scale and clamp its NaN
// quotients to +-127, so a poisoned delta would come back finite and pass a
// finiteness gate.  Here the max keeps NaN (nanmax), max(scale, 1e-12) keeps
// a NaN scale, q is 0 wherever x / safe is NaN, and the scale is written as
// computed (NaN, or inf for a row holding inf): such rows dequantise to NaN.
//
// Bound: device-memory bytes.  Quantise reads R*C*itemsize and writes R*C
// int8 plus 4*R bytes; dequantise reads R*C + 4*R and writes R*C*itemsize;
// a handful of fp32 operations per element is far below the card's balance.
// Any C >= 1 is taken without padding (the Pallas wrapper pads rows to 128
// lanes for the TPU).  Quantise needs each row's amax before it can write,
// so its design is the simple one, streaming element loads in two passes
// over each row:
//   * short rows (C <= 1024): a group of G = min(32, pow2ceil(ceil(C / 4)))
//     lanes of one warp owns a row, so each lane takes about four elements
//     or more (a 5-wide row two lanes, a 256-wide row 32); the amax is a
//     shuffle reduction inside the group, and the second pass re-reads the
//     row from L1/L2;
//   * long rows (up to the 151,936-wide vocabulary of an LM head): one block
//     owns a row, 128 to 1,024 threads (about 16 elements each; the count is
//     a template parameter, so the loop stride is a constant), the amax is
//     a warp-then-block reduction, and the second pass re-reads the row
//     (from L2 while it still fits).  A single long row runs on one SM.
// Dequantise is elementwise, out[i] = float(q[i]) * scale[i / C], so it
// ignores rows: one grid-stride kernel over all R*C elements, four loads in
// flight a thread; up to 2^31 elements it uses 32-bit indices and finds an
// element's row with a multiply-high instead of a division.
// C = 5 or 1027 rows are not 16-byte aligned, so there are no vector loads;
// the int8 stores are element-wise and masked by the loop bounds.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;        // threads per block of the short kernels
constexpr int kMaxThreads = 1024;    // most threads per block of the long ones
constexpr int64_t kShortMax = 1024;  // rows up to this long: a lane group each

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

// max that keeps a NaN from either side (fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float row_scale(float amax) { return __fdiv_rn(amax, 127.0f); }

// max(scale, 1e-12) that keeps a NaN scale NaN, as jnp.maximum / torch.clamp
__device__ __forceinline__ float safe_of(float scale) {
  return scale < 1e-12f ? 1e-12f : scale;
}

__device__ __forceinline__ int8_t quantize_one(float x, float safe) {
  const float r = rintf(__fdiv_rn(x, safe));
  if (r != r) return 0;  // NaN quotient: the row held NaN or inf
  const float c = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return static_cast<int8_t>(static_cast<int>(c));
}

// ---- quantise -------------------------------------------------------------

template <typename T>
__global__ void quantize_short(const T* __restrict__ x, int8_t* __restrict__ q,
                               float* __restrict__ scale, int64_t rows, int C,
                               int log2g) {
  const int G = 1 << log2g;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = t >> log2g;
  const int lane = threadIdx.x & (G - 1);
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * C;
  float m = 0.0f;
  if (live) {
#pragma unroll 4
    for (int c = lane; c < C; c += G) m = nanmax(m, fabsf(to_f32(xr[c])));
  }
  // every lane of the warp reaches the shuffles; xor offsets below G stay
  // inside the row's lane group
  for (int off = G >> 1; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!live) return;
  const float s = row_scale(m);
  const float safe = safe_of(s);
  int8_t* qr = q + row * C;
#pragma unroll 4
  for (int c = lane; c < C; c += G) qr[c] = quantize_one(to_f32(xr[c]), safe);
  if (lane == 0) scale[row] = s;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    quantize_long(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                  int64_t C) {
  __shared__ float warp_max[THREADS / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * C;
  float m = 0.0f;
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < C; c += THREADS) m = nanmax(m, fabsf(to_f32(xr[c])));
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = nanmax(m, warp_max[w]);
  const float s = row_scale(m);
  const float safe = safe_of(s);
  int8_t* qr = q + row * C;
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < C; c += THREADS) qr[c] = quantize_one(to_f32(xr[c]), safe);
  if (threadIdx.x == 0) scale[row] = s;
}

// ---- dequantise -----------------------------------------------------------

constexpr int kUnroll = 4;  // elements a thread of dequantise takes per pass

// j / C for j < 2^31 as (umulhi(j, magic) + j) >> shift, a multiply-high in
// place of a 32-bit division (the divider of Granlund and Montgomery, as
// PyTorch's IntDivider); exact for every such j and C <= 2^31.
struct RowOf32 {
  uint32_t magic, shift;
  explicit RowOf32(uint32_t C) : shift(0) {
    while ((uint64_t{1} << shift) < C) ++shift;
    magic = static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << shift) - C)) / C + 1);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t j) const {
    return (__umulhi(j, magic) + j) >> shift;
  }
};

struct RowOf64 {  // past 2^31 elements: a plain 64-bit division
  int64_t C;
  __device__ __forceinline__ int64_t operator()(int64_t j) const { return j / C; }
};

template <typename T, typename I, typename RowOf>
__global__ void __launch_bounds__(kThreads)
    dequantize(const int8_t* __restrict__ q, const float* __restrict__ scale,
               T* __restrict__ out, I n, RowOf row_of) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += kUnroll * stride) {
    float v[kUnroll], s[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {  // all loads first: four in flight
      const I j = i + k * stride;
      v[k] = j < n ? static_cast<float>(q[j]) : 0.0f;
      s[k] = j < n ? __ldg(scale + row_of(j)) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const I j = i + k * stride;
      if (j < n) out[j] = from_f32<T>(__fmul_rn(v[k], s[k]));
    }
  }
}

// ---- launches -------------------------------------------------------------

int log2_group(int64_t C) {  // lanes per short row: pow2ceil(ceil(C/4)) <= 32
  int g = 0;
  while ((int64_t{4} << g) < C && g < 5) ++g;
  return g;
}

// Calls f(std::integral_constant<int, N>{}) for the threads per long row,
// N = pow2ceil(C / 16) clamped to [128, kMaxThreads].
template <typename F>
void with_long_threads(int64_t C, F&& f) {
  int t = 128;
  while (int64_t{16} * t < C && t < kMaxThreads) t <<= 1;
  if (t == 128) f(std::integral_constant<int, 128>{});
  else if (t == 256) f(std::integral_constant<int, 256>{});
  else if (t == 512) f(std::integral_constant<int, 512>{});
  else f(std::integral_constant<int, kMaxThreads>{});
}

unsigned int short_blocks(int64_t rows, int log2g) {
  return static_cast<unsigned int>(((rows << log2g) + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scale, int64_t rows, int64_t C,
                            cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  if (C <= kShortMax) {
    const int lg = log2_group(C);
    quantize_short<T><<<short_blocks(rows, lg), kThreads, 0, stream>>>(
        xt, qt, st, rows, static_cast<int>(C), lg);
  } else {
    with_long_threads(C, [&](auto threads) {
      constexpr int N = decltype(threads)::value;
      quantize_long<T, N><<<static_cast<unsigned int>(rows), N, 0, stream>>>(xt, qt, st, C);
    });
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize(const void* q, const void* scale, void* out, int64_t rows,
                              int64_t C, cudaStream_t stream) {
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  const int64_t n = rows * C;
  const int64_t per_block = int64_t{kUnroll} * kThreads;
  const unsigned int blocks =
      static_cast<unsigned int>(std::min<int64_t>((n + per_block - 1) / per_block, 1 << 20));
  if (n <= (int64_t{1} << 31))  // i + kUnroll * stride stays below 2^32
    dequantize<T, uint32_t><<<blocks, kThreads, 0, stream>>>(
        qt, st, ot, static_cast<uint32_t>(n), RowOf32(static_cast<uint32_t>(C)));
  else
    dequantize<T, int64_t><<<blocks, kThreads, 0, stream>>>(qt, st, ot, n, RowOf64{C});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, resp. of out): 0 = float32, 1 = bfloat16.  rows >= 1, C >= 1.
// Each returns the cudaError_t of its launch.
int quant8_quantize(const void* x, void* q, void* scale, int64_t rows, int64_t C,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_quantize<float>(x, q, scale, rows, C, s));
  if (dtype == 1)
    return static_cast<int>(launch_quantize<__nv_bfloat16>(x, q, scale, rows, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int quant8_dequantize(const void* q, const void* scale, void* out, int64_t rows, int64_t C,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_dequantize<float>(q, scale, out, rows, C, s));
  if (dtype == 1)
    return static_cast<int>(launch_dequantize<__nv_bfloat16>(q, scale, out, rows, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quant8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
