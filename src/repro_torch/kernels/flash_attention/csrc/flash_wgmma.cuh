// The pieces of the flash-attention kernels that the prefill library
// (flash_attention.cu) and the training library (flash_attention_train.cu)
// share: the launch arguments and mask, the wgmma and TMA helpers, and
// flash_fwd_wgmma with its launch.  Each library includes this header
// once; kernels/build.py hashes it with their sources.
//
// flash_fwd_wgmma<DP, LSE>: with LSE the forward also stores each query
// row's fp32 log-sum-exp of its scaled scores, lse[b, h, t] (natural log;
// rows padded to a.Tp), which the backward kernels recompute P from, and
// the bf16 residual of each output element, o_lo = bf16(o - bf16(o)), so
// that the backward reads o in fp32 to within 2^-17 of itself.  With
// LSE off, as every prefill launches it, the kernel does exactly the work
// it did before the flag and writes the same bits.

#pragma once

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
  float* lse;               // (B, H, Tp) fp32, written by flash_fwd_wgmma<DP, true>
  int Tp;                   // T rounded up to 128 rows (the lse row stride)
  void* o_lo;               // o's bf16 rounding residual, laid out as o (LSE)
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

// two fp32 -> one register of two bf16, x0 in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
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
constexpr float LN2 = 0.6931471805599453f;

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

template <int DP, bool LSE>
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
    if constexpr (LSE) {   // ln sum_j e^(s_j scale) = ln 2 (m + log2 l)
      if (tig == 0)
        a.lse[(int64_t(b) * a.H + h) * a.Tp + t] = (m[r] + log2f(den)) * LN2;
    }
    __nv_bfloat16* orow =
        static_cast<__nv_bfloat16*>(a.o) + ((int64_t(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < a.D) {
        const float x0 = o[4 * j + 2 * r] / den, x1 = o[4 * j + 2 * r + 1] / den;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = hv;
        if constexpr (LSE)   // o = hi + lo to within 2^-17 of the fp32 o
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.o_lo) +
                                       (orow - static_cast<__nv_bfloat16*>(a.o)) + col) =
              pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
      }
    }
  }
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
template <int DP, bool LSE>
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
        flash_fwd_wgmma<DP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(C::SMEM));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(unsigned((a.T + BQW - 1) / BQW), unsigned(a.H), unsigned(B));
  flash_fwd_wgmma<DP, LSE><<<grid, NTW, C::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace
