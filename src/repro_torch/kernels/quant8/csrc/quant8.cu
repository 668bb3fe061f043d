// quant8: symmetric int8 quantisation with one fp32 scale per row, and its
// inverse, each as ONE grouped launch over a list of row-major leaves.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant8/kernel.py:
// quantize_blocked (body _quant_kernel) and dequantize_blocked (body
// _dequant_kernel).  For each leaf x (R, C) row-major, fp32 or bf16
// (converted to fp32 on load), per row:
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
// finiteness gate.  Here the max keeps NaN (an unsigned max of |x|'s bits),
// q is 0 throughout a row whose scale is NaN or inf (there every quotient
// is NaN, or +-0 over an inf scale, and the reference's q is 0), and the
// scale is written as computed: such rows dequantise to NaN.
//
// Bound: device-memory bytes.  Quantise reads R*C*itemsize and writes R*C
// int8 plus 4*R bytes; dequantise reads R*C + 4*R and writes R*C*itemsize;
// a handful of fp32 operations per element is far below the card's balance
// (the IEEE division and rintf per element are the most of them); q is
// packed from float bits rather than converted with F2I, and dequantise
// makes floats of int8 from their bits rather than with I2F, both of which
// run on the conversion unit at an eighth of the fp32 rate.
//
// One exchange hands the kernels a few leaves of a few MB each (P = 8:
// 26.3 MB over 5 leaves), too little for one launch per leaf to fill 132
// SMs or to hide its fixed cost, so the design is:
//
//   * grouped launches.  A call takes up to kCapacity leaves of one dtype.
//     Their table (pointers, shapes, each leaf's first tile and path) is a
//     __grid_constant__ kernel parameter: no host-to-device copy, and a CUDA
//     graph can capture the call.  Block b finds its leaf by a binary search
//     of the first tiles and works on tile b - first of it.
//   * quantise, rows up to kThreads * kLaneElems = 8,192 wide: a group of
//     G lanes owns a row, G = pow2ceil(C / 32) (a 5-wide row 1 lane, 256
//     wide 8, 1,027 wide 64, 4,096 wide 128), and each lane holds its <= 32
//     elements in registers: ONE read of x, an absmax by shuffles inside
//     the group (and across the group's warps through shared memory when
//     G > 32), then q from registers.  Where C and the pointers allow it a
//     lane reads 16 bytes at a time (4 fp32, 8 bf16) and writes their q as
//     one 4- or 8-byte store; else it reads element by element (C = 5,
//     1,027), neighbouring lanes on neighbouring elements.
//   * quantise, longer rows (the 151,936-wide vocabulary row of an LM head):
//     up to C / 8,192 blocks a row, while a leaf has fewer than kWideBlocks
//     of them; each reads the whole row for the absmax and quantises its
//     own slice, reading that again (from L2); element by element.
//   * dequantise: a tile is 256 threads x 8 units of one leaf (fewer units
//     where a launch would have fewer than kMinBlocks blocks, as one leaf
//     of a few MB would), a unit the 4 (fp32) or 8 (bf16) elements of one
//     16-byte store.  With C a multiple of that and aligned pointers a lane
//     loads a unit's int8 (4 or 8 bytes) beside its neighbours, looks its
//     row's scale up once, and writes 16 bytes beside its neighbours; all
//     loads are issued first.  (16 int8 a lane would leave each lane four
//     16-byte stores 64 bytes apart; the stores carry 4/5 of an fp32
//     dequantise's bytes, so they are the ones kept side by side.)  Else a
//     unit is one element (a tile of 2,048 at most, so a small odd leaf
//     such as the exchange's 8 x 1,027 bias spreads over blocks and does
//     not end the launch late).  A unit's (or element's) row is found by a
//     multiply-high in place of a division (64-bit division past 2^31
//     units of a leaf).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One leaf as the C interface takes it.  Quantise: src x (R, C), dst q
// (R, C) int8, scale (R,) fp32.  Dequantise: src q, dst out, scale.
struct Quant8Leaf {
  const void* src;
  void* dst;
  void* scale;
  int64_t rows;
  int64_t cols;
};

namespace {

constexpr int kThreads = 256;     // threads per block of both kernels
constexpr int kCapacity = 32;     // leaves in one launch's table
constexpr int kLaneElems = 32;    // row elements a lane holds in registers
constexpr int kLaneTarget = 32;   // G is chosen to give a lane about this many
constexpr int kStreamElems = 32;  // loads in flight a thread, rows wider still
constexpr int kWideBlocks = 264;  // blocks wider rows aim for: 2 a 132-SM H100
constexpr int kDqUnits = 8;       // units (16-byte stores) a dequantise thread makes
constexpr int kMinBlocks = 528;   // dequantise spreads its work to reach this: 4 an SM
constexpr int kStreamed = -1;     // Leaf::lg of a row too wide to hold: streamed
constexpr int64_t kMaxStreamed = int64_t{1} << 30;  // streamed rows: 32-bit columns

// One leaf of the kernels' table.
struct Leaf {
  const void* src;
  void* dst;
  float* scale;
  int64_t rows, cols;
  int first;        // its first tile (block) in the launch
  int lg;           // quantise: log2 of lanes per row, or kStreamed
  int slices;       // quantise, kStreamed: blocks a row
  int vec;          // 1: 16-byte loads (quantise) or units (dequantise)
  int wide;         // dequantise: 64-bit row division
  uint32_t magic;   // dequantise: unit index -> row, (umulhi(j, magic) + j)
  uint32_t shift;   //   >> shift, a unit being 16 elements (vec) or 1
};

struct Table {
  Leaf leaf[kCapacity];
  int n;
  int units;        // dequantise: units a thread, kDqUnits or fewer
};

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

// Elements of T in 16 bytes: 4 fp32, 8 bf16.
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16 bytes at p (16-byte aligned) -> kVec<T> floats.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of its fp32: exact, as __bfloat162float
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// |v| as bits: for non-negative floats the integer order is the float
// order, and every NaN lies above +inf, so an unsigned max of these keeps a
// NaN (fmaxf would drop it) and yields amax(|x|) bit for bit otherwise
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

__device__ __forceinline__ float row_scale(uint32_t amax_bits) {
  return __fdiv_rn(__uint_as_float(amax_bits), 127.0f);
}

// A row's quantiser: safe = max(scale, 1e-12) as jnp.maximum / torch.clamp
// take it, and q = clip(rint(x / safe), -127, 127) for each x of the row,
// with the IEEE quotient (__fdiv_rn) and rintf as the reference computes
// them.  q is not converted with F2I: adding 1.5 * 2^23 to the clamped
// integral float is exact and leaves q's two's complement in the low byte
// of the sum's bits (0x4B400000's low byte is 0).
//
// A row holding NaN or inf has a NaN or inf scale, and the reference's q
// is 0 throughout it (every quotient is NaN, or +-0 over an inf scale):
// `zero` marks such a row, whose elements the caller quantises as 0; so
// every quotient here is of finite values and the float clamp is exact.
struct RowQ {
  float safe;
  bool zero;
  __device__ __forceinline__ explicit RowQ(float scale)
      : safe(scale < 1e-12f ? 1e-12f : scale), zero(!(scale <= 3.402823466e38f)) {
    if (zero) safe = 1.0f;
  }
  __device__ __forceinline__ uint32_t operator()(float x) const {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(x, safe)), -127.0f), 127.0f);
    return __float_as_uint(r + 12582912.0f);
  }
};

// the low bytes of four words, in order, as one word
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// q of the kVec<T> elements v as one 4- or 8-byte store, little-endian
template <typename T>
__device__ __forceinline__ void store_q(int8_t* p, const RowQ& rq, const float* v) {
  uint32_t w[kVec<T> / 4];
#pragma unroll
  for (int i = 0; i < kVec<T> / 4; ++i)
    w[i] = low_bytes(rq(v[4 * i]), rq(v[4 * i + 1]), rq(v[4 * i + 2]), rq(v[4 * i + 3]));
  if constexpr (kVec<T> == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
  else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ Leaf find_leaf(const Table& t, int tile) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= tile) lo = mid;
    else hi = mid - 1;
  }
  return t.leaf[lo];
}

// The max over a group of 2^lg lanes (lg <= 8) that owns one row.  Every
// thread of the block calls it (it may hold a barrier).
__device__ __forceinline__ uint32_t group_max(uint32_t m, int lg) {
  __shared__ uint32_t warp_max[kThreads / 32];
  for (int off = (lg < 5 ? 1 << lg : 32) >> 1; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lg > 5) {
    const int warp = threadIdx.x >> 5, per_row = 1 << (lg - 5);
    if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
    __syncthreads();
    const int first = warp & ~(per_row - 1);
    m = warp_max[first];
    for (int w = 1; w < per_row; ++w) m = max(m, warp_max[first + w]);
  }
  return m;
}

// ---- quantise -------------------------------------------------------------

// Rows of C <= 2^lg * kLaneElems, 256 >> lg of them per tile, each held in
// the registers of its 2^lg lanes.
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_held(const Leaf& L, int64_t tile) {
  constexpr int W = kVec<T>;
  const int lg = L.lg, G = 1 << lg;
  const int C = static_cast<int>(L.cols);
  const int lane = threadIdx.x & (G - 1);
  const int64_t row = tile * (kThreads >> lg) + (threadIdx.x >> lg);
  const bool live = row < L.rows;
  const T* xr = static_cast<const T*>(L.src) + (live ? row : 0) * C;
  float v[kLaneElems];
  if constexpr (VEC) {  // lane's k-th 16 bytes at column (k * G + lane) * W
#pragma unroll
    for (int k = 0; k < kLaneElems / W; ++k) {
      const int c = (k * G + lane) * W;
      if (live && c < C) {
        load16(xr + c, v + k * W);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) v[k * W + j] = 0.0f;
      }
    }
  } else {  // lane's e-th element at column e * G + lane
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int c = e * G + lane;
      v[e] = live && c < C ? to_f32(xr[c]) : 0.0f;
    }
  }
  uint32_t m = 0;
#pragma unroll
  for (int e = 0; e < kLaneElems; ++e) m = max(m, abs_bits(v[e]));
  m = group_max(m, lg);
  if (!live) return;
  const float s = row_scale(m);
  const RowQ rq(s);
  if (rq.zero) {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) v[e] = 0.0f;
  }
  int8_t* qr = static_cast<int8_t*>(L.dst) + row * C;
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kLaneElems / W; ++k) {
      const int c = (k * G + lane) * W;
      if (c < C) store_q<T>(qr + c, rq, v + k * W);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int c = e * G + lane;
      if (c < C) qr[c] = static_cast<int8_t>(rq(v[e]));
    }
  }
  if (lane == 0) L.scale[row] = s;
}

// A row wider than kThreads * kLaneElems, cut into L.slices slices of one
// block each.  Every block of the row reads the whole row for its absmax
// (the first from device memory, the others mostly from L2) and quantises
// its own slice: the IEEE division, the costly part, spreads over the
// row's blocks, and the max being exact, every block finds the same scale.
// Element by element, kStreamElems loads in flight a thread; neighbouring
// threads read neighbouring elements.
template <typename T>
__device__ __forceinline__ void quantize_streamed(const Leaf& L, int64_t tile) {
  const int C = static_cast<int>(L.cols);
  const int64_t row = tile / L.slices;
  const int slice = static_cast<int>(tile % L.slices);
  const T* xr = static_cast<const T*>(L.src) + row * L.cols;
  int8_t* qr = static_cast<int8_t*>(L.dst) + row * L.cols;
  uint32_t m = 0;
  for (int c0 = threadIdx.x; c0 < C; c0 += kThreads * kStreamElems) {
    float v[kStreamElems];
#pragma unroll
    for (int u = 0; u < kStreamElems; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < C ? to_f32(xr[c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStreamElems; ++u) m = max(m, abs_bits(v[u]));
  }
  m = group_max(m, 8);
  const float s = row_scale(m);
  const RowQ rq(s);
  const int span = (C + L.slices - 1) / L.slices;
  const int lo = slice * span, hi = lo + span < C ? lo + span : C;
  for (int c0 = lo + threadIdx.x; c0 < hi; c0 += kThreads * kStreamElems) {
    float v[kStreamElems];
#pragma unroll
    for (int u = 0; u < kStreamElems; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < hi && !rq.zero ? to_f32(xr[c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStreamElems; ++u) {
      const int c = c0 + u * kThreads;
      if (c < hi) qr[c] = static_cast<int8_t>(rq(v[u]));
    }
  }
  if (slice == 0 && threadIdx.x == 0) L.scale[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    quantize_grouped(const __grid_constant__ Table table) {
  const int tile = blockIdx.x;
  const Leaf L = find_leaf(table, tile);
  const int64_t local = tile - L.first;
  if (L.lg == kStreamed) quantize_streamed<T>(L, local);
  else if (L.vec) quantize_held<T, true>(L, local);
  else quantize_held<T, false>(L, local);
}

// ---- dequantise -----------------------------------------------------------

__device__ __forceinline__ int64_t row_of(const Leaf& L, int64_t unit, int64_t per_row) {
  if (L.wide) return unit / per_row;
  const uint32_t j = static_cast<uint32_t>(unit);
  return static_cast<int64_t>((__umulhi(j, L.magic) + j) >> L.shift);
}

// int8 byte i of w (w's bytes XORed with 0x80) as a float, without the
// conversion unit: 0x4B4000xx is 1.5 * 2^23 + xx exactly
__device__ __forceinline__ float byte_to_f32(uint32_t wx, int i) {
  return __uint_as_float(__byte_perm(wx, 0x4B400000u, 0x7650 + i)) - 12583040.0f;
}

// kVec<T> dequantised values -> one 16-byte store
__device__ __forceinline__ void store16(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* o) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_grouped(const __grid_constant__ Table table) {
  constexpr int E = kVec<T>;  // elements of one 16-byte store: 4 fp32, 8 bf16
  const int tile = blockIdx.x;
  const Leaf L = find_leaf(table, tile);
  const int8_t* q = static_cast<const int8_t*>(L.src);
  T* out = static_cast<T*>(L.dst);
  const int64_t n = L.rows * L.cols;
  const int units = table.units;
  const int64_t base = (tile - L.first) * (int64_t{kThreads} * units * (L.vec ? E : 1));
  if (L.vec) {  // C % E == 0: a unit's E elements lie in one row
    const int64_t per_row = L.cols / E;
    uint32_t w[kDqUnits][E / 4];
    float sv[kDqUnits];
#pragma unroll
    for (int u = 0; u < kDqUnits; ++u) {  // all loads first, lanes side by side
      const int64_t unit = base / E + int64_t{u} * kThreads + threadIdx.x;
      if (u < units && unit * E < n) {
        if constexpr (E == 4) {
          w[u][0] = __ldg(reinterpret_cast<const uint32_t*>(q) + unit);
        } else {
          const uint2 a = __ldg(reinterpret_cast<const uint2*>(q) + unit);
          w[u][0] = a.x;
          w[u][1] = a.y;
        }
        sv[u] = __ldg(L.scale + row_of(L, unit, per_row));
      }
    }
#pragma unroll
    for (int u = 0; u < kDqUnits; ++u) {
      const int64_t unit = base / E + int64_t{u} * kThreads + threadIdx.x;
      if (u >= units || unit * E >= n) continue;
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = __fmul_rn(byte_to_f32(w[u][e >> 2] ^ 0x80808080u, e & 3), sv[u]);
      store16(out + unit * E, o);
    }
  } else {  // a unit is one element; neighbouring threads on neighbours
    float v[kDqUnits], s[kDqUnits];
#pragma unroll
    for (int k = 0; k < kDqUnits; ++k) {  // all loads first
      const int64_t j = base + int64_t{k} * kThreads + threadIdx.x;
      const bool live = k < units && j < n;
      v[k] = live ? static_cast<float>(q[j]) : 0.0f;
      s[k] = live ? __ldg(L.scale + row_of(L, j, L.cols)) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kDqUnits; ++k) {
      const int64_t j = base + int64_t{k} * kThreads + threadIdx.x;
      if (k < units && j < n) out[j] = from_f32<T>(__fmul_rn(v[k], s[k]));
    }
  }
}

// ---- launches -------------------------------------------------------------

bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

int log2_lanes(int64_t C) {  // lanes per held row, or kStreamed
  int lg = 0;
  while ((int64_t{kLaneTarget} << lg) < C && (1 << lg) < kThreads) ++lg;
  return C <= (int64_t{kLaneElems} << lg) ? lg : kStreamed;
}

// unit index -> row for `per_row` units a row, exact below 2^31 units: the
// divider of Granlund and Montgomery, as PyTorch's IntDivider
void set_divider(Leaf& L, int64_t per_row, int64_t units) {
  L.wide = units > (int64_t{1} << 31) || per_row > (int64_t{1} << 31);
  L.shift = 0;
  L.magic = 0;
  if (L.wide) return;
  const uint64_t d = static_cast<uint64_t>(per_row);
  while ((uint64_t{1} << L.shift) < d) ++L.shift;
  L.magic = static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << L.shift) - d)) / d + 1);
}

// Fills the table from `args`, leaving out empty leaves, dequantise threads
// with kDqUnits / spread units each; -> the tile count, or -1 if it would
// not fit a grid or a streamed row is kMaxStreamed wide or wider.
int64_t fill(Table& t, const Quant8Leaf* args, int n, bool quantize, int vec_elems,
             int spread) {
  int64_t tiles = 0;
  t.n = 0;
  t.units = kDqUnits / spread;
  for (int i = 0; i < n; ++i) {
    const Quant8Leaf& a = args[i];
    if (a.rows <= 0 || a.cols <= 0) continue;
    Leaf& L = t.leaf[t.n++];
    L.src = a.src;
    L.dst = a.dst;
    L.scale = static_cast<float*>(a.scale);
    L.rows = a.rows;
    L.cols = a.cols;
    L.first = static_cast<int>(tiles);
    int64_t count;
    if (quantize) {
      L.lg = log2_lanes(a.cols);
      L.vec = a.cols % vec_elems == 0 && aligned(a.src, 16) && aligned(a.dst, vec_elems);
      L.wide = 0;
      L.magic = L.shift = 0;
      // a streamed row: a slice of at least kThreads * kLaneElems a block,
      // and more blocks a row only while the leaf has too few rows to fill
      // kWideBlocks (each of a row's blocks reads the whole row)
      const int64_t most = (a.cols + kThreads * kLaneElems - 1) / (kThreads * kLaneElems);
      const int64_t want = (kWideBlocks + a.rows - 1) / a.rows;
      L.slices = L.lg == kStreamed ? static_cast<int>(most < want ? most : want) : 1;
      if (L.lg == kStreamed && a.cols >= kMaxStreamed) return -1;
      count = L.lg == kStreamed ? a.rows * L.slices
                                : (a.rows + (kThreads >> L.lg) - 1) / (kThreads >> L.lg);
    } else {
      // a unit: the vec_elems elements of one 16-byte store, or one
      L.lg = 0;
      L.slices = 1;
      L.vec = a.cols % vec_elems == 0 && aligned(a.src, vec_elems) && aligned(a.dst, 16);
      const int64_t unit = L.vec ? vec_elems : 1;
      const int64_t tile = int64_t{kThreads} * t.units * unit;
      set_divider(L, a.cols / unit, a.rows * a.cols / unit);
      count = (a.rows * a.cols + tile - 1) / tile;
    }
    tiles += count;
    if (tiles >= (int64_t{1} << 31)) return -1;
  }
  return tiles;
}

template <typename T>
cudaError_t launch(const Quant8Leaf* args, int n, bool quantize, cudaStream_t stream) {
  if (n < 0 || n > kCapacity) return cudaErrorInvalidValue;
  // dequantise: the most units a thread whose launch still has kMinBlocks
  // blocks; a short list (one leaf of a few MB) spreads over more blocks
  Table t;
  int64_t tiles = 0;
  for (int spread = 1; spread <= kDqUnits; spread *= 2) {
    tiles = fill(t, args, n, quantize, kVec<T>, spread);
    if (quantize || tiles < 0 || tiles >= kMinBlocks) break;
  }
  if (tiles < 0) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  const unsigned int grid = static_cast<unsigned int>(tiles);
  if (quantize) quantize_grouped<T><<<grid, kThreads, 0, stream>>>(t);
  else dequantize_grouped<T><<<grid, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Leaves one launch takes; a longer list is the caller's to split.
int quant8_group_capacity() { return kCapacity; }

// n <= quant8_group_capacity() leaves, all of one dtype (of x, resp. of
// out): 0 = float32, 1 = bfloat16.  Leaves with no element are left out;
// with none left nothing is launched.  Each returns the cudaError_t of its
// one launch.
int quant8_quantize_grouped(const Quant8Leaf* leaves, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(leaves, n, true, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(leaves, n, true, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int quant8_dequantize_grouped(const Quant8Leaf* leaves, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(leaves, n, false, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(leaves, n, false, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quant8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
