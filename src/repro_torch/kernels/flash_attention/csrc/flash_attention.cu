// flash_attention: causal and/or sliding-window GQA attention, forward only,
// with an fp32 online softmax.  (Self attention that carries a gradient
// runs on flash_attention_train.cu, a library of its own: the wgmma forward
// of flash_wgmma.cuh with the row log-sum-exp saved, and the backward.)
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
// flash_fwd_wgmma (in flash_wgmma.cuh; bf16 that TMA can describe: D and
// every batch, time and head stride a multiple of 8 elements and none 0,
// q/k/v 16-byte aligned; D <= 256; both models' prefills and every smoke
// config with D % 8 == 0).
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

#include "flash_wgmma.cuh"   // Args, the mask, the wgmma forward

namespace {

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

cudaError_t launch_wgmma(const Args& a, int64_t B, int64_t Hkv,
                         cudaStream_t s) {
  if (a.D <= 64) return launch_wgmma_dp<64, false>(a, B, Hkv, s);
  if (a.D <= 128) return launch_wgmma_dp<128, false>(a, B, Hkv, s);
  return launch_wgmma_dp<256, false>(a, B, Hkv, s);
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