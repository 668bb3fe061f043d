// flash_attention: causal and/or sliding-window GQA attention, forward only,
// with an fp32 online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:105
// flash_attention_bhtd (body _flash_kernel) and computes what its oracle
// ref.attention_ref computes.  For q (B, T, H, D), k/v (B, S, Hkv, D) with
// S == T (self-attention, prefill), G = H / Hkv, query head h reads kv head
// h / G, and for each query row t:
//
//   s[j] = (q[t] . k[j]) * (1/sqrt(D))        fp32, inputs widened exactly
//   s[j] = -1e30 where masked: causal j > t, window j <= t - window, j >= S
//   o[t] = sum_j softmax(s)[j] v[j]           fp32 m, l, acc; l >= 1e-30
//
// written in the input dtype (fp32, or bf16 rounded to nearest even).
//
// Layout: the tensors lie as the model gives them, (B, T, H, D) with the
// last dim contiguous; the wrapper passes the batch, time and head strides,
// so no transposed copy is made (the Pallas wrapper transposes to BHTD).
// The output is a fresh contiguous (B, T, H, D) tensor.  Any T: the tail
// tile is masked (the Pallas kernel asserts T % bq == 0).  Any D from 1 to
// 256: the kernels are instantiated for a few padded head dims and pad with
// zeros in shared memory, which changes no dot product.
//
// Shared by the three kernels below:
//   * one block per (q tile, head, batch); the heaviest q tiles (latest,
//     most live kv tiles under a causal mask) are launched first, so the
//     short ones fill the tail of the grid;
//   * a loop over kv tiles takes the place of the Pallas grid's sequential
//     kv axis; kv tiles that the mask leaves wholly dead are not visited
//     (the Pallas kernel's pl.when skip), so a causal prefill does about
//     half the work of the rectangle;
//   * masked entries get p = 0 explicitly (not exp(-1e30 - m)), so a row
//     whose entries in a live tile are all masked adds nothing to l or acc,
//     whatever order the tiles are visited in.  The Pallas kernel leaves
//     p = exp(0) = 1 there until a later tile with a real score resets it
//     through corr = 0; both give the same result;
//   * P stays fp32 to within 2^-17 of itself: it is split as P = hi + lo,
//     both bf16, and PV is two bf16 products, hi V + lo V, summed in fp32
//     (V is bf16, so each product is exact).  That is what the full-width
//     logits checks of chip_smoke.py were calibrated on; it costs half
//     again the tensor work of PV.
//
// Three routes; the wrapper (kernel.py: route) picks one by shape and
// passes it in, and a route asked for on tensors it cannot take is refused
// (cudaErrorInvalidValue), never replaced:
//
// flash_fwd_wgmma (bf16 that TMA can describe: D and every batch, time and
// head stride a multiple of 8 elements and none 0, q/k/v 16-byte aligned;
// D <= 256; both models' prefills and every smoke config with D % 8 == 0).
// One block of two consumer warpgroups and one producer warp per (128 query
// rows, head, batch):
//   * the producer warp's first thread issues TMA loads
//     (cp.async.bulk.tensor over 4-d maps (D, H, T, B) encoded on the host
//     per call) of the Q tile once and of K and V tiles into a ring of 2
//     shared-memory stages, with an mbarrier per stage for "full"
//     (transaction bytes) and one for "empty" (the 8 consumer warps): the
//     next tile is in flight while the tensor cores work on this one, and
//     no consumer thread spends an instruction or a __syncthreads on a load
//     (flash_fwd_mma below loads each tile with all 128 threads behind two
//     __syncthreads, nothing in flight during the math);
//   * each consumer warpgroup owns 64 query rows: S = Q K^T by wgmma (both
//     operands from shared memory, K-major as they lie), the online softmax
//     in registers with exp2 on scores scaled by scale * log2(e), then
//     O += P V by wgmma with A = P from registers (the S accumulator's
//     layout is the register-A layout) and B = V from shared memory read
//     MN-major (transposed by the descriptor).  wgmma is the only way to
//     Hopper's full tensor rate; mma.sync reaches a fraction of it.  Each
//     warpgroup runs its S, softmax and P V in turn; the two share the
//     SM's tensor cores and exp2 units (see PERF.md for what that costs);
//   * tiles are 128 keys for D <= 128 and 64 for D = 256, whose O
//     accumulator (64 x 256 fp32) is 128 registers a thread: the tensor
//     core path for D = 256, which flash_fwd_mma does not reach (bf16 with
//     D > 128 would otherwise run on fp32 FMAs);
//   * registers: the launch bounds give 168 a thread, and ptxas (CUDA 12.8)
//     keeps every branch within them, setmaxnreg or not (measured: the
//     D = 256 consumer spills 400-550 bytes either way; unbounded, it takes
//     218, which a block of 288 threads cannot launch).  So the producer is
//     one warp, not a warpgroup, and no setmaxnreg is issued; D = 256
//     spills about 400 bytes a thread, D = 128 about 80;
//   * the shared tiles use the 128-byte swizzle that TMA writes and the
//     wgmma descriptors read: a row of D = 128 is two 64-column swizzle
//     atoms, each atom its own TMA box; D is padded to 64, 128 or 256 by
//     the box, which TMA fills with zeros past D (and past T);
//   * only tiles that straddle the diagonal, the window edge or the end of
//     T are masked element by element; a wholly live tile skips the mask.
//
// flash_fwd_mma (bf16 that TMA cannot describe, D <= 128: D not a multiple
// of 8, or an odd stride): tensor cores through mma.sync m16n8k16.  Each of
// 4 warps owns 16 query rows of a 64-row tile.  Q, K and V tiles of 64 keys
// are staged in shared memory as bf16 by all threads (rows padded by 8
// elements, so ldmatrix and its 16-byte rows hit distinct banks); Q's
// fragments stay in registers.
//
// flash_fwd_fma (fp32 inputs, which no main path uses, and bf16 with
// D > 128 that TMA cannot describe): fp32 FMAs.  Q (transposed, [d][row]),
// K (transposed, [d][key]) and V ([key][d]) tiles are staged through shared
// memory as fp32; each thread computes an 8 x 4 block of scores (float4
// shared loads), the row max and sum reduce with shuffles over the 16 lanes
// that share a row, P goes back to shared memory (over K's tile, which is
// dead by then) and each thread accumulates 8 rows x DMAX/16 output
// columns.
//
// Bound on the H100: operations.  A causal prefill at granite-20b's width
// (B 8, T 2,048, H 48, Hkv 1, D 128, bf16) does 4*B*H*D*T(T+1)/2 = 4.13e11
// FLOPs on 0.41 GB of q/k/v/o: 0.417 ms at the bf16 tensor-core peak
// (989 TFLOP/s), 0.12 ms at 3.35 TB/s; with the split P the tensor cores
// do 1.5x that, 0.63 ms.  recurrentgemma-9b's (B 2, T 2,048, H 16, Hkv 1,
// D 256, window 2,048) does 6.88e10 FLOPs: 0.070 ms, 0.104 ms with the
// split P.  Nothing in the kernels calls a library.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py); the TMA maps are encoded
// through cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime, so the library needs no -lcuda.

#include "../../csrc_common/tma.cuh"   // mbarriers, the TMA map encoder
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 128;       // threads per block
constexpr float NEG = -1e30f; // masked score (not -inf: m_prev - m_new)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, H, G, D;           // S == T; G = H / Hkv
  int64_t qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  int causal, window;
  float scale;
};

// kv tiles [lo, hi) of bk keys that the mask leaves live for the query
// rows [q_lo, q_lo + rows)
__device__ __forceinline__ void live_tiles(const Args& a, int q_lo, int& lo,
                                           int& hi, int rows = BQ,
                                           int bk = BK) {
  lo = 0;
  hi = (a.T + bk - 1) / bk;
  if (a.causal) hi = min(hi, (q_lo + rows - 1) / bk + 1);
  if (a.window) {   // live iff k_lo + bk - 1 > q_lo - window
    const int first = q_lo - a.window - bk + 2;
    if (first > 0) lo = (first + bk - 1) / bk;
  }
}

__device__ __forceinline__ bool unmasked(const Args& a, int qp, int kp) {
  return kp < a.T && (!a.causal || kp <= qp) &&
         (!a.window || kp > qp - a.window);
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// flash_fwd_fma: fp32 FMAs (fp32 inputs; bf16 with D > 128)
// ---------------------------------------------------------------------------

constexpr int LDT = BQ + 4;   // row stride (floats) of the transposed tiles

// Output columns of one thread: NG groups of VW adjacent columns, group g of
// lane tx at g * 16 * VW + tx * VW, so the 16 lanes of a row read adjacent
// vectors of a V row.
template <int DMAX> struct Cols {
  static constexpr int VW = DMAX >= 64 ? 4 : 2;
  static constexpr int NG = DMAX / (16 * VW);
  static constexpr int N = NG * VW;
};

template <int DMAX>
constexpr size_t fma_smem_bytes() {
  // Q^T [DMAX][LDT], K^T [max(DMAX, BQ)][LDT] (P [BQ][LDT] over it), V [BK][DMAX]
  return sizeof(float) * (size_t(DMAX) * LDT + size_t(DMAX > BQ ? DMAX : BQ) * LDT
                          + size_t(BK) * DMAX);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_fma(const Args a) {
  using C = Cols<DMAX>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + DMAX * LDT;
  float* Ps = Ks;                                   // reused once S is done
  float* Vs = Ks + (DMAX > BQ ? DMAX : BQ) * LDT;

  const int iq = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int q_lo = iq * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * 8;                            // this thread's 8 rows
  const int c0 = tx * 4;                            // and 4 score columns
  const int D = a.D;

  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  for (int idx = tid; idx < BQ * DMAX; idx += NT) {
    const int r = idx / DMAX, d = idx % DMAX;
    float x = 0.f;
    if (q_lo + r < a.T && d < D) x = to_f32(qb[(q_lo + r) * a.qst + d]);
    Qs[d * LDT + r] = x;
  }

  int kt_lo, kt_hi;
  live_tiles(a, q_lo, kt_lo, kt_hi);

  float m[8], l[8], acc[8][C::N];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();   // the previous tile's P and V reads are done
    for (int idx = tid; idx < BK * DMAX; idx += NT) {
      const int c = idx / DMAX, d = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k_lo + c < a.T && d < D) {
        kx = to_f32(kb[(k_lo + c) * a.kst + d]);
        vx = to_f32(vb[(k_lo + c) * a.vst + d]);
      }
      Ks[d * LDT + c] = kx;
      Vs[c * DMAX + d] = vx;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * LDT + r0]);
      const float4 qc = *reinterpret_cast<const float4*>(&Qs[d * LDT + r0 + 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[d * LDT + c0]);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    unsigned live = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = unmasked(a, q_lo + r0 + i, k_lo + c0 + j);
        s[i][j] = ok ? s[i][j] * a.scale : NEG;
        if (!ok) live &= ~(1u << (i * 4 + j));
      }

    float corr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (live >> (i * 4 + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();   // every thread is done reading K^T: P goes over it
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(&Ps[(r0 + i) * LDT + c0]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] *= corr[i];
    __syncthreads();

    for (int cb = 0; cb < BK; cb += 4) {
      float4 p4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(r0 + i) * LDT + cb]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &Vs[(cb + cc) * DMAX + tx * C::VW];
        float vv[C::N];
#pragma unroll
        for (int g = 0; g < C::NG; ++g) {
          if constexpr (C::VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + g * 64);
            vv[g * 4 + 0] = t.x; vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z; vv[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + g * 32);
            vv[g * 2 + 0] = t.x; vv[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y
                        : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < C::N; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  // o[b, t, h, :] = acc / max(l, 1e-30), contiguous (B, T, H, D)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q_lo + r0 + i;
    if (t >= a.T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = static_cast<T*>(a.o) + ((int64_t(b) * a.T + t) * a.H + h) * D;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) {
        const int col = g * 16 * C::VW + tx * C::VW + e;
        if (col < D) orow[col] = from_f32<T>(acc[i][g * C::VW + e] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_mma: bf16 tensor cores (mma.sync m16n8k16), D <= 128
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16, x0 in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a (T, D) bf16 matrix with row stride `st` into a
// [64][LD] shared tile, zero outside T x D (rows past the end, pad columns);
// element by element: the layouts routed here are those TMA cannot describe
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t st, int row0, const Args& a) {
  constexpr int LD = DP + 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < 64 * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    dst[r * LD + d] = row0 + r < a.T && d < a.D ? src[(row0 + r) * st + d]
                                                : zero;
  }
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * 64 * (DP + 8);   // Q, K, V tiles
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd_mma(const Args a) {
  constexpr int LD = DP + 8;      // bf16 elements per shared row
  constexpr int KC = DP / 16;     // k chunks of the head dim
  constexpr int NO = DP / 8;      // n tiles of the output
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int iq = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int q_lo = iq * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;                        // this warp's 16 rows

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + hk * a.ksh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + hk * a.vsh;

  load_tile<DP>(Qs, qb, a.qst, q_lo, a);
  __syncthreads();
  // Q's A fragments for the warp's 16 rows, every k chunk: ldmatrix lanes
  // 0-7 address rows 0-7 cols 0-7, 8-15 rows 8-15, 16-23 rows 0-7 cols
  // 8-15, 24-31 rows 8-15 cols 8-15
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qf[kc], Qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        kc * 16 + (lane >> 4) * 8);

  int kt_lo, kt_hi;
  live_tiles(a, q_lo, kt_lo, kt_hi);

  // each thread: rows gid and gid + 8 of the warp's 16; output columns
  // nt * 8 + tig * 2 + {0, 1} of every n tile nt
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();   // the previous tile's K and V reads are done
    load_tile<DP>(Ks, kb, a.kst, k_lo, a);
    load_tile<DP>(Vs, vb, a.vst, k_lo, a);
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T: 8 n tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // n tiles 2np, 2np + 1
        uint32_t kf[4];
        ldsm_x4(kf, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }

    // mask, online softmax over the two rows this thread holds
    unsigned live = 0xffffffffu;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q_lo + wr + gid + (e >> 1) * 8;
        const int kp = k_lo + nt * 8 + tig * 2 + (e & 1);
        const bool ok = unmasked(a, qp, kp);
        s[nt][e] = ok ? s[nt][e] * a.scale : NEG;
        if (!ok) live &= ~(1u << (nt * 4 + e));
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = (live >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m_new) : 0.f;
          sum += s[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0]; o[nt][1] *= corr[0];
      o[nt][2] *= corr[1]; o[nt][3] *= corr[1];
    }

    // O += P V over 4 chunks of 16 keys; P = hi + lo in bf16
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      const float pv[8] = {s[2 * kc][0], s[2 * kc][1], s[2 * kc][2],
                           s[2 * kc][3], s[2 * kc + 1][0], s[2 * kc + 1][1],
                           s[2 * kc + 1][2], s[2 * kc + 1][3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[2 * j], pv[2 * j + 1]);
        ph[j] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[j] = pack_bf16(pv[2 * j] - __low2float(hi),
                          pv[2 * j + 1] - __high2float(hi));
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {   // n tiles 2dp, 2dp + 1
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }

  // o[b, t, h, :] = O / max(l, 1e-30), contiguous (B, T, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q_lo + wr + gid + r * 8;
    if (t >= a.T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        static_cast<__nv_bfloat16*>(a.o) + ((int64_t(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + tig * 2 + e;
        if (col < a.D) orow[col] = __float2bfloat16(o[nt][2 * r + e] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 through TMA and wgmma, D <= 256
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int NWG = 2;                   // consumer warpgroups per block
constexpr int BQW = NWG * WG_ROWS;       // query rows per block
constexpr int NTW = NWG * 128 + 32;      // + one producer warp
constexpr int STAGES = 2;                // ring of K/V tiles
constexpr int ATOM = 64;                 // bf16 columns per 128-byte swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

template <int DP> struct Wg {
  static constexpr int BK = DP == 256 ? 64 : 128;   // keys per kv tile
  static constexpr int NA = DP / ATOM;               // swizzle atoms per row
  static constexpr int Q_BYTES = NA * BQW * 128;     // [atom][row][128 B]
  static constexpr int KV_BYTES = NA * BK * 128;     // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 /* alignment slack */ + Q_BYTES +
                                 STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
};

// one box of the 4-d map (D, H, T, B) at (d, h, t, b) into shared `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(h), "r"(t), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: 8-row groups 1024 bytes
// apart (SBO); `lbo` is the distance between 64-column atoms of an MN-major
// operand (ignored for K-major ones, where it is 1 by convention)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators change under the compiler's feet until wg_wait_all: no
// read of them may move across this point
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x; -inf (a masked score) -> 0, results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, fp32) (+)= A (64 x 16, smem) B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 128, fp32) (+)= A (64 x 16, smem) B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  if constexpr (BK == 64) wgmma_ss64(d, da, db, acc);
  else wgmma_ss128(d, da, db, acc);
}

template <int DP>
__global__ void __launch_bounds__(NTW, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Wg<DP>;
  constexpr int BK = C::BK, NA = C::NA;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // Q
  const uint32_t skv = sq + C::Q_BYTES;      // stage s: K atoms, V atoms
  const uint32_t q_full = skv + STAGES * C::STAGE_BYTES;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int q_lo = iq * BQW;
  int lo, hi;
  live_tiles(a, q_lo, lo, hi, BQW, BK);
  // warp-uniform in the compiler's eyes (NWG: the producer warp), so the
  // role branches and every wgmma below sit in uniform control flow
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: one thread keeps the ring of K/V tiles full
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int at = 0; at < NA; ++at)
        tma_load(sq + at * BQW * 128, &tq, q_full, at * ATOM, h, q_lo, b);
      for (int i = lo, n = 0; i < hi; ++i, ++n) {
        const int s = n % STAGES;
        // round n / STAGES of stage s: wait for the previous round's release
        if (n >= STAGES) mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t ks = skv + s * C::STAGE_BYTES, vs = ks + C::KV_BYTES;
        mbar_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
        for (int at = 0; at < NA; ++at) {
          tma_load(ks + at * BK * 128, &tk, full, at * ATOM, hk, i * BK, b);
          tma_load(vs + at * BK * 128, &tv, full, at * ATOM, hk, i * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [r0, r0 + 64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q_lo + wg * WG_ROWS;
  int wlo, whi;                     // this warpgroup's live tiles
  live_tiles(a, r0, wlo, whi, WG_ROWS, BK);
  const float sl2 = a.scale * LOG2E;
  const uint32_t qa = sq + wg * WG_ROWS * 128;

  // accumulator layouts (S and O alike): thread holds rows gid and gid + 8
  // of its warp's 16, columns 8j + 2 tig + {0, 1}: d[4j + 2 half + e]
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // m in log2 units
  mbar_wait(q_full, 0);

  for (int i = lo, n = 0; i < hi; ++i, ++n) {
    const int s = n % STAGES;
    mbar_wait(full0 + 8 * s, (n / STAGES) & 1);
    if (i >= wlo && i < whi) {
      const uint32_t ks = skv + s * C::STAGE_BYTES, vs = ks + C::KV_BYTES;
      // S = Q K^T, 16 columns of D a step; 4 steps per swizzle atom
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns, 32 bytes
        wgmma_ss<BK>(sc, sw128_desc(qa + (kk / 4) * BQW * 128 + off, 16),
                     sw128_desc(ks + (kk / 4) * BK * 128 + off, 16), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(sc);

      const int k_lo = i * BK;
      if (k_lo + BK > a.T || (a.causal && k_lo + BK - 1 > r0) ||
          (a.window && k_lo <= r0 + WG_ROWS - 1 - a.window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + warp * 16 + gid + (e >> 1) * 8;
            const int kp = k_lo + j * 8 + tig * 2 + (e & 1);
            if (!unmasked(a, qp, kp)) sc[4 * j + e] = -INFINITY;   // p = 0
          }
      }
      // online softmax: p = 2^(s sl2 - m), m the running max of s sl2
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * sl2);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -m_new));
            sum += sc[4 * j + e];
          }
        corr[r] = ex2(m[r] - m_new);
        l[r] = l[r] * corr[r] + sum;     // this thread's columns; the quad
        m[r] = m_new;                    // sums them at the end
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= corr[0]; o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1]; o[4 * j + 3] *= corr[1];
      }
      // P = hi + lo in bf16, as register A fragments of 16 keys each
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kc + 2 * r], x1 = sc[8 * kc + 2 * r + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
          ph[kc][r] = *reinterpret_cast<const uint32_t*>(&hv);
          pl[kc][r] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
        }
      // O += P V: V's 16 keys of step kc start 16 rows (2,048 bytes) on;
      // its 64-column atoms lie BK * 128 bytes apart
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        if constexpr (DP == 64) {
          const uint64_t dv = sw128_desc(vs + kc * 2048, BK * 128);
          wgmma_rs64(o, ph[kc], dv);
          wgmma_rs64(o, pl[kc], dv);
        } else {
#pragma unroll
          for (int half = 0; half < DP / 128; ++half) {
            const uint64_t dv =
                sw128_desc(vs + half * 2 * BK * 128 + kc * 2048, BK * 128);
            wgmma_rs128(o + 64 * half, ph[kc], dv);
            wgmma_rs128(o + 64 * half, pl[kc], dv);
          }
        }
      }
      wg_commit();
      wg_wait_all();
      reg_fence(o);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done with s
  }

  // o[b, t, h, :] = O / max(l, 1e-30), contiguous (B, T, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = r0 + warp * 16 + gid + r * 8;
    if (t >= a.T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        static_cast<__nv_bfloat16*>(a.o) + ((int64_t(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// one launch of the kernel for (T, DP), on the fp32-FMA or the mma path
template <typename T, int DP, bool MMA>
cudaError_t launch(const Args& a, int64_t B, cudaStream_t stream) {
  void (*kernel)(const Args);
  size_t smem;
  if constexpr (MMA) {
    kernel = flash_fwd_mma<DP>;
    smem = mma_smem_bytes<DP>();
  } else {
    kernel = flash_fwd_fma<T, DP>;
    smem = fma_smem_bytes<DP>();
  }
  static bool opted_in = false;   // above 48 KB of shared memory only after
  if (!opted_in) {                // opting in, once per kernel
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(unsigned((a.T + BQ - 1) / BQ), unsigned(a.H), unsigned(B));
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const Args& a, int64_t B, cudaStream_t s) {
  if (a.D <= 32) return launch<T, 32, false>(a, B, s);
  if (a.D <= 64) return launch<T, 64, false>(a, B, s);
  if (a.D <= 128) return launch<T, 128, false>(a, B, s);
  return launch<T, 256, false>(a, B, s);
}

cudaError_t launch_mma(const Args& a, int64_t B, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a.D <= 16) return launch<bf16, 16, true>(a, B, s);
  if (a.D <= 32) return launch<bf16, 32, true>(a, B, s);
  if (a.D <= 64) return launch<bf16, 64, true>(a, B, s);
  return launch<bf16, 128, true>(a, B, s);
}

// (B, T, H, D) bf16 with element strides -> the 4-d map (D, H, T, B) whose
// box is 64 columns (one swizzle atom) x 1 head x `rows` rows x 1 batch;
// reads past D or T are filled with zeros
bool tensor_map(CUtensorMap* map, const void* base, int64_t B, int64_t T,
                int64_t H, int64_t D, int64_t sb, int64_t st, int64_t sh,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(st) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {ATOM, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps are kernel parameters (__grid_constant__), so a CUDA graph that
// captures the launch keeps them
template <int DP>
cudaError_t launch_wgmma_dp(const Args& a, int64_t B, int64_t Hkv,
                            cudaStream_t stream) {
  using C = Wg<DP>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, B, a.T, a.H, a.D, a.qsb, a.qst, a.qsh, BQW) ||
      !tensor_map(&tk, a.k, B, a.T, Hkv, a.D, a.ksb, a.kst, a.ksh, C::BK) ||
      !tensor_map(&tv, a.v, B, a.T, Hkv, a.D, a.vsb, a.vst, a.vsh, C::BK))
    return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(C::SMEM));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(unsigned((a.T + BQW - 1) / BQW), unsigned(a.H), unsigned(B));
  flash_fwd_wgmma<DP><<<grid, NTW, C::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const Args& a, int64_t B, int64_t Hkv,
                         cudaStream_t s) {
  if (a.D <= 64) return launch_wgmma_dp<64>(a, B, Hkv, s);
  if (a.D <= 128) return launch_wgmma_dp<128>(a, B, Hkv, s);
  return launch_wgmma_dp<256>(a, B, Hkv, s);
}

}  // namespace

extern "C" {

// route: 0 flash_fwd_fma, 1 flash_fwd_mma, 2 flash_fwd_wgmma (kernel.py's
// route() chooses); dtype: 0 fp32, 1 bf16 (q, k, v and o alike).  Strides
// are in elements.  Returns a cudaError_t, 0 on success;
// cudaErrorInvalidValue for a route that cannot take these tensors.  The
// wrapper (kernel.py) has checked shapes, strides and types.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t T, int64_t H, int64_t Hkv,
                        int64_t D, int64_t qsb, int64_t qst, int64_t qsh,
                        int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                        int64_t vst, int64_t vsh, int causal, int window,
                        float scale, int dtype, int route, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256 || T > INT32_MAX || B > 65535 || H > 65535 || window < 0 ||
      (dtype != 0 && dtype != 1) || route < 0 || route > 2)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, o, int(T), int(H), int(H / Hkv), int(D), qsb, qst,
               qsh, ksb, kst, ksh, vsb, vst, vsh, causal, window, scale};
  // what TMA can describe: D and every stride a multiple of 8 elements (16
  // bytes) and none 0, bases 16-byte aligned (kernel.py: route)
  const int64_t all = D | qsb | qst | qsh | ksb | kst | ksh | vsb | vst | vsh;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const bool tma = all % 8 == 0 && ptrs % 16 == 0 && qsb > 0 && qst > 0 &&
                   qsh > 0 && ksb > 0 && kst > 0 && ksh > 0 && vsb > 0 &&
                   vst > 0 && vsh > 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (dtype != 1 || !tma) return int(cudaErrorInvalidValue);
    return int(launch_wgmma(a, B, Hkv, s));
  }
  if (route == 1) {
    if (dtype != 1 || D > 128) return int(cudaErrorInvalidValue);
    return int(launch_mma(a, B, s));
  }
  return int(dtype == 0 ? launch_fma<float>(a, B, s)
                        : launch_fma<__nv_bfloat16>(a, B, s));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
