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
// __fadd_rn, no fused multiply-add), in t order, so both kernels below
// equal the plain version (ref.py), which runs the same loop as PyTorch
// ops, bit for bit.  They differ from the JAX scans only in the order of
// the sums.  Splitting T into chunks with a carry pass would change that
// order (and read more bytes), so neither kernel does.
//
// Bound on the H100: device-memory bytes.  Every element of a and b is
// read once and every h written once, 12 bytes an element for fp32 inputs
// and 2 operations: falcon-mamba-7b's prefill scan at 4 x 2,048 tokens
// (D = 8,192 x 16 = 131,072) moves 12.9 GB, 3.85 ms at 3.35 TB/s;
// recurrentgemma-9b's at 2 x 2,048 (D = 4,096) 0.201 GB, 60 us.
//
// Two routes; the wrapper (kernel.py: route) picks one from shapes,
// strides and alignment and passes it in, and a route asked for on tensors
// it cannot take is refused (cudaErrorInvalidValue), never replaced.
//
// linrec_tma (route 1: a and b that TMA can describe, T of a tile or more;
// both models' prefills).  A block owns BW = 64 contiguous d of one b, as
// STRIPS = 2 strips of 32, and walks all of T:
//   * one producer thread keeps time tiles of TT = 32 steps x 64 columns of
//     a and b in flight, TMA loads (cp.async.bulk.tensor over 3-d maps
//     (D, T, B) with the views' own strides, encoded on the host per call)
//     into a ring of STAGES = 4 shared-memory stages, with an mbarrier per
//     stage for "full" (transaction bytes) and one for "empty" (every
//     consumer thread).  A block keeps up to 64 KB of fp32 loads in flight
//     where the column kernel's thread kept 32 words: at recurrentgemma's
//     8,192 columns (128 blocks, one an SM) that is about 8 MB across the
//     card, above the 2.5-3 MB that 3.35 TB/s at HBM latency asks for,
//     where the column kernel reached about 1 MB and 25 % of its bound;
//   * each consumer warp owns a strip of 32 columns, one a lane, with h in
//     a register: it copies a tile's a and b from shared memory to
//     registers (a lane reads its own column, the warp one 128-byte row:
//     no bank conflicts), releases the stage, then runs the dependent chain
//     of the tile's 32 steps.  The chain is about 2,048 x 8 cycles a strip,
//     some 10 us, well inside the byte bound even at the narrow shape;
//   * h is stored straight from registers: each step of a warp is one
//     coalesced 128-byte line (a full line when D % 32 == 0), the store is
//     fire-and-forget, and a TMA store would need a second ring and a
//     barrier between the consumers and the thread that starts it for no
//     fewer bytes;
//   * TMA fills the box past D and past T with zeros; those columns and
//     steps are neither computed into h nor stored.
// TMA can describe a and b when their bases are 16-byte aligned, the
// batch and time strides are positive multiples of 16 bytes and D is a
// multiple of 4 (fp32) or 8 (bf16) elements.
//
// linrec_column (route 0: every other layout, and short T such as a decode
// step, where a tile of 32 steps would mostly be padding): one thread owns
// one (b, d) column and walks T with h in a register; neighbouring threads
// take neighbouring d, so each warp's load of a time step is one
// contiguous 128-byte line (64 bytes in bf16).  UNROLL time steps of both
// inputs are requested together before the dependent chain, so a thread
// keeps 2 * UNROLL loads in flight.  It needs only d contiguous.
//
// Layout: a and b may be strided views along batch and time (the wrapper
// passes those strides); d must be contiguous.  h0, when given, is a
// contiguous (B, D) fp32 tensor; out is a fresh contiguous (B, T, D) fp32
// tensor.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py); the TMA maps are encoded
// through cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime (no libcuda is linked), and passed as __grid_constant__
// parameters, so a CUDA graph that captures the launch keeps them.

#include "../../csrc_common/tma.cuh"   // mbarriers, the TMA map encoder
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short raw) {
  // bf16 -> fp32 is exact: the 16 bits are the top half of the fp32 word
  return __uint_as_float(static_cast<unsigned int>(raw) << 16);
}

// the storage type a kernel reads: fp32 as float, bf16 as its 16 bits
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

// ---------------------------------------------------------------------------
// linrec_column: one thread a column
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int UNROLL = 16;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return widen(__ldg(reinterpret_cast<const typename Raw<T>::type*>(p)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linrec_column(const T* __restrict__ a, const T* __restrict__ b,
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

// ---------------------------------------------------------------------------
// linrec_tma: strips of columns fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int STRIP = 32;                 // columns of a consumer warp
constexpr int STRIPS = 2;                 // consumer warps of a block
constexpr int BW = STRIP * STRIPS;        // columns of a block: the box width
constexpr int TT = 32;                    // time steps of a tile
constexpr int STAGES = 4;                 // tiles in the ring
constexpr int TMA_THREADS = 32 * (STRIPS + 1);   // + the producer warp

template <typename T> struct Ring {
  static constexpr int TILE_BYTES = TT * BW * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;          // a, then b
  static constexpr int SMEM = 128 /* alignment slack */ + STAGES * STAGE_BYTES
                              + 16 * STAGES;                   // full, empty
};

// one box of the 3-d map (D, T, B) at (d, t, b) into shared `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(t), "r"(b)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(TMA_THREADS)
linrec_tma(const __grid_constant__ CUtensorMap ma,
           const __grid_constant__ CUtensorMap mb,
           const float* __restrict__ h0, float* __restrict__ out, int T_len,
           int64_t D, int chunks) {
  using R = Ring<T>;
  using Word = typename Raw<T>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t full0 = ring0 + STAGES * R::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int bi = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - bi * chunks) * BW;
  const int tiles = (T_len + TT - 1) / TT;
  // warp-uniform in the compiler's eyes, so the role branch is uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, STRIPS * 32);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == STRIPS) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        // round i / STAGES of stage s: wait for the previous round's release
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t dst = ring0 + s * R::STAGE_BYTES;
        mbar_expect_tx(full, R::STAGE_BYTES);
        tma_load(dst, &ma, full, c0, i * TT, bi);
        tma_load(dst + R::TILE_BYTES, &mb, full, c0, i * TT, bi);
      }
    }
    return;
  }

  // consumers: warp w owns columns c0 + 32 w + lane
  const int col = warp * STRIP + lane;
  const int64_t d = c0 + col;
  const bool live = d < D;
  float h = h0 != nullptr && live ? h0[bi * D + d] : 0.0f;
  float* po = out + static_cast<int64_t>(bi) * T_len * D + d;
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const Word* ta = reinterpret_cast<const Word*>(ring + s * R::STAGE_BYTES) + col;
    const Word* tb = ta + TT * BW;
    float ra[TT], rb[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      ra[j] = widen(ta[j * BW]);
      rb[j] = widen(tb[j * BW]);
    }
    mbar_arrive(empty0 + 8 * s);   // the tile is in registers: refill it
    const int steps = T_len - i * TT;
    if (live) {
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        if (j < steps) {
          h = __fadd_rn(__fmul_rn(ra[j], h), rb[j]);
          po[j * D] = h;
        }
      }
    }
    po += TT * D;
  }
}

// (B, T, D) with element strides (sb, st, 1) -> the 3-d map (D, T, B) whose
// box is BW columns x TT steps x 1 batch; reads past D or T are zeros
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, int64_t B, int64_t T_len,
                int64_t D, int64_t sb, int64_t st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(T_len), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(st) * sizeof(T),
                                 cuuint64_t(sb) * sizeof(T)};
  const cuuint32_t box[3] = {BW, TT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA can describe: 16-byte aligned bases, batch and time strides
// positive multiples of 16 bytes below 2^40, D a multiple of 16 bytes.  A
// stride over an axis of extent 1 is never used and is set to one that
// is; kernel.py's tma_ok holds the same rule.
bool tma_ok(const void* a, const void* b, int64_t T_len, int64_t D,
            int64_t itemsize, int64_t& sa_b, int64_t& sa_t, int64_t& sb_b,
            int64_t& sb_t, int64_t B) {
  if (T_len == 1) sa_t = sb_t = D;
  if (B == 1) { sa_b = sa_t * T_len; sb_b = sb_t * T_len; }
  const int64_t strides[4] = {sa_b, sa_t, sb_b, sb_t};
  for (int64_t s : strides)
    if (s <= 0 || (s * itemsize) % 16 != 0 || s * itemsize >= (int64_t{1} << 40))
      return false;
  return (D * itemsize) % 16 == 0 && T_len < (int64_t{1} << 31) &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* out,
                   int64_t B, int64_t T_len, int64_t D, int64_t sa_b,
                   int64_t sa_t, int64_t sb_b, int64_t sb_t, int route,
                   cudaStream_t stream) {
  if (route == 0) {
    const int64_t blocks = (B * D + THREADS - 1) / THREADS;
    if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
    linrec_column<T><<<static_cast<unsigned int>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h0, out, B, T_len, D,
        sa_b, sa_t, sb_b, sb_t);
    return cudaGetLastError();
  }
  if (!tma_ok(a, b, T_len, D, sizeof(T), sa_b, sa_t, sb_b, sb_t, B))
    return cudaErrorInvalidValue;
  const int64_t chunks = (D + BW - 1) / BW;
  if (B * chunks >= (int64_t{1} << 31) || B >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map<T>(&ma, a, B, T_len, D, sa_b, sa_t) ||
      !tensor_map<T>(&mb, b, B, T_len, D, sb_b, sb_t))
    return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        linrec_tma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  linrec_tma<T><<<static_cast<unsigned int>(B * chunks), TMA_THREADS,
                  Ring<T>::SMEM, stream>>>(ma, mb, h0, out,
                                           static_cast<int>(T_len), D,
                                           static_cast<int>(chunks));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// route: 0 linrec_column, 1 linrec_tma (kernel.py's route() chooses);
// dtype: 0 = float32, 1 = bfloat16 (a and b).  h0 may be null (zeros).
// Strides are in elements.  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a route that cannot take these tensors.
int linrec_launch(const void* a, const void* b, const void* h0, void* out,
                  int64_t B, int64_t T_len, int64_t D, int64_t sa_b,
                  int64_t sa_t, int64_t sb_b, int64_t sb_t, int dtype,
                  int route, void* stream) {
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || D <= 0 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, b, h, o, B, T_len, D, sa_b, sa_t,
                                          sb_b, sb_t, route, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a, b, h, o, B, T_len, D, sa_b,
                                                   sa_t, sb_b, sb_t, route, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* linrec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
