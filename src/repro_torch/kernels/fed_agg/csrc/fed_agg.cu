// fed_agg: K-way weighted aggregation of a parameter tree in ONE launch,
//
//   out_l[n] = sum_k w[k] * x_{k,l}[n]     for every leaf l of the tree.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_agg/kernel.py:fed_agg_2d
// (body _fed_agg_kernel), which takes the members as one (K, N) array.
// Each leaf is fp32 or bf16 (one launch takes both); w holds K fp32
// weights; the sum accumulates in fp32 in k order and is written in the
// leaf's dtype (round-to-nearest-even for bf16, as torch's .to(bfloat16)).
// Each product and each sum is rounded on its own (__fmul_rn / __fadd_rn:
// no fused multiply-add), from an accumulator that starts at +0, so the
// kernel equals the plain version (ref.py) and the reference's
// core.aggregation.weighted_average bit for bit.
//
// Bound: device-memory bytes.  Each input element is read once and each
// output written once, (K+1)*N*itemsize bytes, for 2*K*N flops -- far below
// the card's flop/byte balance.  At the main path's size (an async merge:
// K = 2 over flight-cnn-mnist's 6 leaves, 20,490 fp32, 0.25 MB) that is
// 0.07 us, below what any launch costs, so the design's aim is that a
// merge is one launch and nothing else on the device:
//
//   * grouped launch.  The table of one launch (a __grid_constant__ kernel
//     parameter: no host-to-device copy, and a CUDA graph can capture the
//     call) holds, for each part, its output pointer, its length, its dtype
//     code, its first tile and its run of K member slots; each slot holds
//     an input pointer and its weight BY VALUE (no weight tensor on the
//     device, so the host never copies one there nor waits on the stream).
//     Block b finds its part by a binary search of the first tiles.
//   * capacity.  A table of kSlots = 2,048 slots and kParts = 128 parts
//     is 29,704 bytes, within Hopper's 32,764-byte parameter limit: a
//     tree of L leaves and K members is one launch while L <= 128 and
//     K * L <= 2,048 (16 members of 128 leaves, 2,048 members of one).
//     The wrapper (kernel.py: plan) splits a longer tree into more
//     launches; a leaf with more members than one launch holds is split
//     in k order, its parts carrying an fp32 partial sum (`acc`) between
//     launches and casting it once in the last, so the result stays
//     bit-equal.
//   * streaming.  A tile is 256 threads x 16 bytes of one leaf (1,024 fp32
//     or 2,048 bf16): a thread owns VEC = 16 / itemsize contiguous outputs,
//     reads them with one 16-byte load per member and loops over k with
//     the accumulators in registers.  Where a part's pointers are all
//     16-byte aligned, whole vectors go 16 bytes at a time; the ragged end
//     of a leaf and unaligned leaves go element by element.  Nothing is
//     padded (the Pallas kernel pads N up to its 2048-wide tile).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One part of a grouped launch as the C interface takes it (kernel.py packs
// eight int64): out[i] = (acc ? acc[i] : 0) + sum_{j < k} w[slot + j] *
// x[slot + j][i] for i < n, in the leaf's dtype, or in fp32 when `partial`.
struct FedAggPart {
  void* out;
  const float* acc;   // an earlier launch's fp32 partial sum, or null
  int64_t n;
  int64_t first;      // its first tile in the launch
  int64_t slot;       // its first member slot
  int64_t k;          // its member slots
  int64_t dtype;      // 0 = float32, 1 = bfloat16 (inputs; out unless partial)
  int64_t partial;    // 1: out is an fp32 partial sum for a later launch
};

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 2048, kParts = 128;

struct Part {
  void* out;
  const float* acc;
  int64_t n;
  int first, slot, k;
  uint8_t dtype, partial, vec, pad;
};

struct Table {
  const void* x[kSlots];
  float w[kSlots];
  Part part[kParts];
  int n;
};

static_assert(sizeof(Table) <= 32764,
              "a table must fit Hopper's kernel-parameter limit");

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

// the thread's VEC outputs of part P from tile `tile`
template <typename T>
__device__ __forceinline__ void merge(const Table& t, const Part& P, int tile) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t i0 = (static_cast<int64_t>(tile - P.first) * kThreads + threadIdx.x) * VEC;
  if (i0 >= P.n) return;
  const int m = P.n - i0 < VEC ? static_cast<int>(P.n - i0) : VEC;
  const bool whole = P.vec && m == VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  if (P.acc != nullptr) {
    const float* a = P.acc + i0;
    if (whole) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(a) + q);
        acc[4 * q] = v.x; acc[4 * q + 1] = v.y; acc[4 * q + 2] = v.z; acc[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < m) acc[e] = a[e];
    }
  }
  for (int j = 0; j < P.k; ++j) {
    const float wj = t.w[P.slot + j];
    const T* x = static_cast<const T*>(t.x[P.slot + j]) + i0;
    if (whole) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, to_f32(v[e])));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < m) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, to_f32(x[e])));
    }
  }
  if (P.partial) {
    float* o = static_cast<float*>(P.out) + i0;
    if (whole) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        reinterpret_cast<float4*>(o)[q] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < m) o[e] = acc[e];
    }
    return;
  }
  T* o = static_cast<T*>(P.out) + i0;
  if (whole) {
    alignas(16) T v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < m) o[e] = from_f32<T>(acc[e]);
  }
}

__global__ void __launch_bounds__(kThreads)
    fed_agg_grouped(const __grid_constant__ Table t) {
  const int tile = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.part[mid].first <= tile) lo = mid;
    else hi = mid - 1;
  }
  const Part& P = t.part[lo];
  if (P.dtype == 0) merge<float>(t, P, tile);
  else merge<__nv_bfloat16>(t, P, tile);
}

// the launch floor the grouped kernel is measured against (chip_smoke.py)
__global__ void fed_agg_empty() {}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Fills a table from the C interface's records, checking each; -> the tile
// count, or -1 for a table the kernel cannot take.
int64_t fill(Table& t, const FedAggPart* parts, int n_parts,
             const void* const* x, const float* w, int n_slots) {
  if (n_parts < 1 || n_parts > kParts || n_slots < 1 || n_slots > kSlots) return -1;
  t.n = n_parts;
  for (int s = 0; s < n_slots; ++s) {
    t.x[s] = x[s];
    t.w[s] = w[s];
  }
  int64_t tiles = 0;
  for (int i = 0; i < n_parts; ++i) {
    const FedAggPart& a = parts[i];
    if (a.n < 1 || a.k < 1 || a.slot < 0 || a.slot + a.k > n_slots ||
        (a.dtype != 0 && a.dtype != 1) || a.first != tiles)
      return -1;
    Part& P = t.part[i];
    P.out = a.out;
    P.acc = a.acc;
    P.n = a.n;
    P.first = static_cast<int>(tiles);
    P.slot = static_cast<int>(a.slot);
    P.k = static_cast<int>(a.k);
    P.dtype = static_cast<uint8_t>(a.dtype);
    P.partial = a.partial != 0;
    P.pad = 0;
    bool vec = aligned(a.out) && (a.acc == nullptr || aligned(a.acc));
    for (int64_t j = 0; j < a.k; ++j) vec = vec && aligned(x[a.slot + j]);
    P.vec = vec;
    const int64_t tile = int64_t{kThreads} * (a.dtype == 0 ? 4 : 8);
    tiles += (a.n + tile - 1) / tile;
    if (tiles >= (int64_t{1} << 31)) return -1;
  }
  return tiles;
}

}  // namespace

extern "C" {

// Parts and member slots one launch takes; a longer tree is the caller's
// to split (kernel.py: plan).
int fed_agg_capacity_slots() { return kSlots; }
int fed_agg_capacity_parts() { return kParts; }

// One grouped launch over n_parts parts (their first tiles in order from
// 0) and n_slots member slots (x[s] an input pointer, w[s] its weight).
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for a table
// it cannot take.
int fed_agg_grouped_launch(const FedAggPart* parts, int n_parts,
                           const void* const* x, const float* w, int n_slots,
                           void* stream) {
  Table t;
  const int64_t tiles = fill(t, parts, n_parts, x, w, n_slots);
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  fed_agg_grouped<<<static_cast<unsigned int>(tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

int fed_agg_empty_launch(void* stream) {
  fed_agg_empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* fed_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
