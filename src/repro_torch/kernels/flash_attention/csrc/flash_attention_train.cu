// flash_attention_train: self attention that carries a gradient, on the
// card -- the forward with the row log-sum-exp saved, and the backward.
//
// Replaces no TPU kernel: the reference differentiates only its plain
// attention (src/repro/models/layers.py attention_full), which the port ran
// on the card as fp32 einsums over a materialised (B, H, T, S) score
// tensor.  These kernels compute the same gradients without that tensor;
// their plain counterpart, tile for tile, is ref.py's attention_bwd_ref.
// For q (B, T, H, D), k/v (B, T, Hkv, D), G = H / Hkv, query head h reading
// kv head h / G, scale = 1/sqrt(D), the mask of flash_attention.cu, and
// the output gradient dO:
//
//   forward   o = softmax(s) v, s = q k^T scale; lse[t] = ln sum_j e^(s[t,j])
//   delta[t]  = sum_d dO[t,d] o[t,d] = sum_j P[t,j] dP[t,j]  (flash_bwd_delta)
//   P         = exp(s - lse), recomputed from q, k and the saved lse
//   dP        = dO v^T
//   dS        = P (dP - delta)
//   dq        = scale dS k                                (flash_bwd_dq_wgmma)
//   dk        = scale dS^T q,  dv = P^T dO                (flash_bwd_dkdv_wgmma)
//
// Precision: nothing is kept at lower precision than attention_full keeps
// it.  S, the softmax statistics, dP and dS are fp32, and every product
// accumulates in fp32.  P enters dv, and dS enters dq and dk, as a pair
// hi + lo of bf16 values (x = hi + lo to within 2^-17 of x), each product
// exact on bf16 q, k, v and dO -- the forward's own split of P
// (flash_wgmma.cuh).  dq, dk and dv are written in bf16, as autograd gives
// them for bf16 inputs.  delta reads o in fp32, as the forward's bf16 o
// plus its residual o_lo: from the bf16 o alone, each row of dS would sum
// to a rounding error of o instead of zero, an error that every key of the
// row shares.
//
// Same bits on every call: no atomics.  dq is summed by a query-stationary
// kernel over key tiles in order, dk and dv by a key-stationary kernel over
// the query tiles of each query head of its kv head, in order.  The price
// is S and dP computed twice, once in each.
//
// flash_bwd_dq_wgmma (one block per 128 query rows, head, batch; the grid
// and roles of flash_fwd_wgmma): a producer warp loads the Q and dO tiles
// once and keeps a ring of K and V tiles of 64 keys in flight by TMA; each
// of two consumer warpgroups owns 64 query rows and, per live key tile,
// issues S = Q K^T and dP = dO V^T by wgmma (both operands from shared
// memory), forms dS in registers, and accumulates dq += dS K by wgmma with
// dS as register A fragments (the accumulator's layout) and K read
// MN-major.  Key tiles that the mask leaves wholly dead are not loaded.
//
// flash_bwd_dkdv_wgmma (one block per 64 keys, kv head, batch): the K and V
// tiles stay in shared memory; a producer warp streams a ring of Q and dO
// tiles of 64 rows, with their lse and delta, over every query head of the
// group and every live query tile; one consumer warpgroup issues S^T = K
// Q^T and dP^T = V dO^T, forms P^T and dS^T, and accumulates dv += P^T dO
// and dk += dS^T Q (A from registers, B = dO or Q read MN-major).  Its two
// 64 x D fp32 accumulators take 2 x D / 2 registers a thread, so one
// warpgroup owns a block (160 threads, up to 255 registers each): two would
// need twice that.  Query tiles wholly below the diagonal (causal) or past
// the window are not visited, so causal training does about half the
// rectangle's work in both kernels.
//
// D from 33 to 128 (padded to 64 or 128 by the TMA box, which fills zeros
// past D and past T); bf16 that TMA can describe (kernel.py: route ==
// "wgmma").  Built with -DFLASH_TRAIN_DP=64 or 128 it holds only that head
// dim's kernels (kernels/build.py builds only what a run launches); without
// the flag, both.
//
// Bound on the H100: operations.  Per live (query, key) pair and head the
// backward does 2 D FLOPs in each of S, dP, dv, dk and dq (10 D; 14 D
// with S and dP twice), the splits double dv, dk and dq on the tensor
// cores (20 D issued).  At qwen1.5-4b's train shape (B 8, T 1,024, H 20,
// D 128, causal): 10 D x 5.25e5 pairs x 160 = 1.08e11 FLOPs, 0.109 ms at
// 989 TFLOP/s; 0.218 ms as issued.

#include "flash_wgmma.cuh"

#ifndef FLASH_TRAIN_DP
#define FLASH_TRAIN_64 1
#define FLASH_TRAIN_128 1
#else
#define FLASH_TRAIN_64 (FLASH_TRAIN_DP == 64)
#define FLASH_TRAIN_128 (FLASH_TRAIN_DP == 128)
#endif

namespace {

constexpr int BKB = 64;            // keys per tile (both backward kernels)
constexpr int BQB = 64;            // query rows per tile of flash_bwd_dkdv
constexpr int KV_NT = 128 + 32;    // one consumer warpgroup, one producer warp
constexpr int KV_STAGES = 2;       // ring of Q/dO tiles

struct Bwd {
  Args a;                  // q, k, v, o, lse and their shapes, mask, scale
  const void* o_lo;        // o's bf16 residual (B, T, H, D), contiguous
  const void* dout;        // dO (B, T, H, D), strides in elements
  int64_t dsb, dst, dsh;
  float* delta;            // (B, H, Tp): rowsum(dO o), 0 past T
  void* dq;                // (B, T, H, D) contiguous
  void* dk;                // (B, T, Hkv, D) contiguous
  void* dv;
  int Hkv;
};

template <int DP> struct Bw {
  static constexpr int NA = DP / ATOM;
  static constexpr int TILE = NA * 64 * 128;     // 64 rows, [atom][row][128 B]
  static constexpr int QROWS = NA * BQW * 128;   // 128 rows
  // dq: Q and dO of 128 rows, a ring of K and V tiles
  static constexpr size_t DQ_SMEM = 1024 + 2 * QROWS + STAGES * 2 * TILE +
                                    8 * (1 + 2 * STAGES);
  // dk/dv: K and V, a ring of Q and dO tiles, then each stage's lse and
  // delta (64 floats each)
  static constexpr size_t KV_SMEM = 1024 + 2 * TILE + KV_STAGES * 2 * TILE +
                                    KV_STAGES * 2 * BQB * 4 +
                                    8 * (1 + 2 * KV_STAGES);
};

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// x = hi + lo as register A fragments of 16 columns each: fragment kc, word
// r holds columns 16 kc + 8 (r / 2) + 2 tig + {0, 1} of row gid + 8 (r % 2),
// which is where the accumulator layout keeps them (flash_fwd_wgmma's P)
__device__ __forceinline__ void split_fragments(const float (&x)[32],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kc + 2 * r], x1 = x[8 * kc + 2 * r + 1];
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
      hi[kc][r] = *reinterpret_cast<const uint32_t*>(&hv);
      lo[kc][r] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
    }
}

// acc (64 x DP, fp32) += A (64 x 64: hi + lo fragments, 4 steps of 16) B,
// B a 64-row tile of shared memory read MN-major (64 rows of DP columns)
template <int DP>
__device__ __forceinline__ void acc_split(float (&acc)[DP / 2],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          uint32_t tile) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    // rows 16 kc on (2,048 bytes); 64-column atoms 64 * 128 bytes apart
    const uint64_t db = sw128_desc(tile + kc * 2048, 64 * 128);
    if constexpr (DP == 64) {
      wgmma_rs64(acc, hi[kc], db);
      wgmma_rs64(acc, lo[kc], db);
    } else {
      wgmma_rs128(acc, hi[kc], db);
      wgmma_rs128(acc, lo[kc], db);
    }
  }
}

// d (64 x 64, fp32) = A B^T over DP columns: A 64 rows at `ta` with atoms
// `sa` bytes apart, B a 64-row tile at `tb` (atoms 64 * 128 apart), both
// K-major; issued, not waited for
template <int DP>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t ta,
                                       uint32_t sa, uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns, 32 bytes
    wgmma_ss64(d, sw128_desc(ta + (kk / 4) * sa + off, 16),
               sw128_desc(tb + (kk / 4) * 64 * 128 + off, 16), kk > 0);
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] (o + o_lo)[b, t, h, d] in fp32, and
// 0 for T <= t < Tp; one warp a row, rows in delta's order
__global__ void __launch_bounds__(256) flash_bwd_delta(const Bwd p,
                                                       int64_t rows) {
  const Args& a = p.a;
  const int64_t row = (int64_t(blockIdx.x) * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int t = int(row % a.Tp);
  const int64_t bh = row / a.Tp;
  const int h = int(bh % a.H), b = int(bh / a.H);
  float s = 0.f;
  if (t < a.T) {
    const int64_t at = ((int64_t(b) * a.T + t) * a.H + h) * a.D;
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o) + at;
    const __nv_bfloat16* ol = static_cast<const __nv_bfloat16*>(p.o_lo) + at;
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(p.dout) +
                             b * p.dsb + t * p.dst + h * p.dsh;
    for (int c = 2 * lane; c < a.D; c += 64) {   // D is a multiple of 8
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + c));
      const float2 xl = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ol + c));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(d + c));
      s = fmaf(x.x + xl.x, y.x, s);
      s = fmaf(x.y + xl.y, y.y, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row] = s;
}

template <int DP>
__global__ void __launch_bounds__(NTW, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const Bwd p) {
  using C = Bw<DP>;
  constexpr int NA = C::NA;
  const Args& a = p.a;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // Q
  const uint32_t sdo = sq + C::QROWS;                           // dO
  const uint32_t skv = sdo + C::QROWS;    // stage s: K atoms, V atoms
  const uint32_t q_full = skv + STAGES * 2 * C::TILE;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int q_lo = iq * BQW;
  int lo, hi;
  live_tiles(a, q_lo, lo, hi, BQW, BKB);
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
    // producer: Q and dO once (two 64-row boxes an atom), then the ring
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, 2 * C::QROWS);
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t off = at * BQW * 128 + half * 64 * 128;
          tma_load(sq + off, &tq, q_full, at * ATOM, h, q_lo + 64 * half, b);
          tma_load(sdo + off, &tdo, q_full, at * ATOM, h, q_lo + 64 * half,
                   b);
        }
      for (int i = lo, n = 0; i < hi; ++i, ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t ks = skv + s * 2 * C::TILE, vs = ks + C::TILE;
        mbar_expect_tx(full, 2 * C::TILE);
#pragma unroll
        for (int at = 0; at < NA; ++at) {
          tma_load(ks + at * 64 * 128, &tk, full, at * ATOM, hk, i * BKB, b);
          tma_load(vs + at * 64 * 128, &tv, full, at * ATOM, hk, i * BKB, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [r0, r0 + 64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q_lo + wg * WG_ROWS;
  int wlo, whi;
  live_tiles(a, r0, wlo, whi, WG_ROWS, BKB);
  const float sl2 = a.scale * LOG2E;
  const uint32_t qa = sq + wg * WG_ROWS * 128, da = sdo + wg * WG_ROWS * 128;
  // this thread's rows gid and gid + 8 of its warp's 16: lse in log2 units
  // and delta (rows past T read what lies there; they are not written)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = (int64_t(b) * a.H + h) * a.Tp + r0 + warp * 16 + gid +
                       8 * r;
    lse2[r] = a.lse[at] * LOG2E;
    dl[r] = p.delta[at];
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int i = lo, n = 0; i < hi; ++i, ++n) {
    const int s = n % STAGES;
    mbar_wait(full0 + 8 * s, (n / STAGES) & 1);
    if (i >= wlo && i < whi) {
      const uint32_t ks = skv + s * 2 * C::TILE, vs = ks + C::TILE;
      float sc[32], dp[32];
      wg_fence();
      scores<DP>(sc, qa, BQW * 128, ks);
      scores<DP>(dp, da, BQW * 128, vs);
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      const int k_lo = i * BKB;
      const bool edge = k_lo + BKB > a.T ||
                        (a.causal && k_lo + BKB - 1 > r0) ||
                        (a.window && k_lo <= r0 + WG_ROWS - 1 - a.window);
      // d[4 j + 2 half + e]: row gid + 8 half, column 8 j + 2 tig + e
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pv = ex2(fmaf(sc[4 * j + e], sl2, -lse2[r]));
          if (edge && !unmasked(a, r0 + warp * 16 + gid + 8 * r,
                                k_lo + 8 * j + 2 * tig + (e & 1)))
            pv = 0.f;
          dp[4 * j + e] = pv * (dp[4 * j + e] - dl[r]);   // dS
        }
      uint32_t dsh[4][4], dsl[4][4];
      split_fragments(dp, dsh, dsl);
      wg_fence();
      acc_split<DP>(dq, dsh, dsl, ks);   // dq += dS K
      wg_commit();
      wg_wait_all();
      reg_fence(dq);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done with s
  }

  // dq[b, t, h, :] = scale dq, contiguous (B, T, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + warp * 16 + gid + r * 8;
    if (t >= a.T) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(p.dq) +
                         ((int64_t(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// query tiles [lo, hi) of BQB rows that the mask leaves live for the keys
// [k_lo, k_lo + BKB)
__device__ __forceinline__ void live_qtiles(const Args& a, int k_lo, int& lo,
                                            int& hi) {
  lo = a.causal ? k_lo / BQB : 0;
  hi = (a.T + BQB - 1) / BQB;
  // live iff some query row q <= k_lo + BKB - 1 + window - 1
  if (a.window) hi = min(hi, (k_lo + BKB + a.window - 2) / BQB + 1);
}

template <int DP>
__global__ void __launch_bounds__(KV_NT, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const Bwd p) {
  using C = Bw<DP>;
  constexpr int NA = C::NA;
  const Args& a = p.a;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;   // K
  const uint32_t sv = sk + C::TILE;                             // V
  const uint32_t sst = sv + C::TILE;   // stage s: Q atoms, dO atoms
  const uint32_t sls = sst + KV_STAGES * 2 * C::TILE;   // stage s: lse, delta
  const uint32_t kv_full = sls + KV_STAGES * 2 * BQB * 4;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * KV_STAGES;
  const float* lsd = reinterpret_cast<const float*>(
      smem_raw + (sls - smem_u32(smem_raw)));

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k_lo = blockIdx.x * BKB;   // the first key tiles are the heaviest
  int qlo, qhi;
  live_qtiles(a, k_lo, qlo, qhi);
  const int nq = max(qhi - qlo, 0), steps = a.G * nq;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    // producer: K and V once, then Q, dO, lse and delta for every query
    // head of the group and every live query tile, in that order
    if (threadIdx.x == 128) {
      mbar_expect_tx(kv_full, 2 * C::TILE);
#pragma unroll
      for (int at = 0; at < NA; ++at) {
        tma_load(sk + at * 64 * 128, &tk, kv_full, at * ATOM, hk, k_lo, b);
        tma_load(sv + at * 64 * 128, &tv, kv_full, at * ATOM, hk, k_lo, b);
      }
      for (int n = 0; n < steps; ++n) {
        const int h = hk * a.G + n / nq, q_lo = (qlo + n % nq) * BQB;
        const int s = n % KV_STAGES;
        if (n >= KV_STAGES)
          mbar_wait(empty0 + 8 * s, ((n / KV_STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t qs = sst + s * 2 * C::TILE, ds = qs + C::TILE;
        mbar_expect_tx(full, 2 * C::TILE + 2 * BQB * 4);
#pragma unroll
        for (int at = 0; at < NA; ++at) {
          tma_load(qs + at * 64 * 128, &tq, full, at * ATOM, h, q_lo, b);
          tma_load(ds + at * 64 * 128, &tdo, full, at * ATOM, h, q_lo, b);
        }
        // rows padded to Tp, a multiple of 128: 256-byte aligned, in bounds
        const int64_t row = (int64_t(b) * a.H + h) * a.Tp + q_lo;
        const uint32_t ls = sls + s * 2 * BQB * 4;
        bulk_load(ls, a.lse + row, BQB * 4, full);
        bulk_load(ls + BQB * 4, p.delta + row, BQB * 4, full);
      }
    }
    return;
  }

  // the consumer warpgroup: keys k_lo + 16 warp + gid + 8 half
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float sl2 = a.scale * LOG2E;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int n = 0; n < steps; ++n) {
    const int q_lo = (qlo + n % nq) * BQB;
    const int s = n % KV_STAGES;
    mbar_wait(full0 + 8 * s, (n / KV_STAGES) & 1);
    const uint32_t qs = sst + s * 2 * C::TILE, ds = qs + C::TILE;
    const float* lse = lsd + s * 2 * BQB;
    const float* delta = lse + BQB;
    float st[32], dpt[32];   // S^T and dP^T: keys x queries
    wg_fence();
    scores<DP>(st, sk, 64 * 128, qs);
    scores<DP>(dpt, sv, 64 * 128, ds);
    wg_commit();
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    const bool edge = q_lo + BQB > a.T || k_lo + BKB > a.T ||
                      (a.causal && q_lo < k_lo + BKB - 1) ||
                      (a.window && q_lo + BQB - 1 >= k_lo + a.window);
    // d[4 j + 2 half + e]: key 16 warp + gid + 8 half, query 8 j + 2 tig + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tig + e;
        const float l2 = lse[c] * LOG2E, dd = delta[c];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * j + 2 * half + e;
          float pv = ex2(fmaf(st[x], sl2, -l2));
          if (edge) {
            const int qp = q_lo + c, kp = k_lo + warp * 16 + gid + 8 * half;
            if (qp >= a.T || !unmasked(a, qp, kp)) pv = 0.f;
          }
          st[x] = pv;                          // P^T
          dpt[x] = pv * (dpt[x] - dd);         // dS^T
        }
      }
    uint32_t ph[4][4], pl[4][4], dsh[4][4], dsl[4][4];
    split_fragments(st, ph, pl);
    split_fragments(dpt, dsh, dsl);
    wg_fence();
    acc_split<DP>(dv, ph, pl, ds);     // dv += P^T dO
    acc_split<DP>(dk, dsh, dsl, qs);   // dk += dS^T Q
    wg_commit();
    wg_wait_all();
    reg_fence(dv);
    reg_fence(dk);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done with s
  }

  // dk[b, t, hk, :] = scale dk, dv[b, t, hk, :] = dv, contiguous
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = k_lo + warp * 16 + gid + 8 * half;
    if (t >= a.T) continue;
    const int64_t at = ((int64_t(b) * a.T + t) * p.Hkv + hk) * a.D;
    __nv_bfloat16* krow = static_cast<__nv_bfloat16*>(p.dk) + at;
    __nv_bfloat16* vrow = static_cast<__nv_bfloat16*>(p.dv) + at;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) = __floats2bfloat162_rn(
            dk[4 * j + 2 * half] * a.scale, dk[4 * j + 2 * half + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) = __floats2bfloat162_rn(
            dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bwd(const Bwd& p, int64_t B, cudaStream_t stream) {
  using C = Bw<DP>;
  const Args& a = p.a;
  CUtensorMap tq, tk, tv, tdo;   // 64-row boxes
  if (!tensor_map(&tq, a.q, B, a.T, a.H, a.D, a.qsb, a.qst, a.qsh, 64) ||
      !tensor_map(&tk, a.k, B, a.T, p.Hkv, a.D, a.ksb, a.kst, a.ksh, 64) ||
      !tensor_map(&tv, a.v, B, a.T, p.Hkv, a.D, a.vsb, a.vst, a.vsh, 64) ||
      !tensor_map(&tdo, p.dout, B, a.T, a.H, a.D, p.dsb, p.dst, p.dsh, 64))
    return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(C::DQ_SMEM));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(C::KV_SMEM));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int64_t rows = B * a.H * a.Tp;
  flash_bwd_delta<<<unsigned((rows + 7) / 8), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<DP><<<dim3(unsigned((a.T + BQW - 1) / BQW),
                                unsigned(a.H), unsigned(B)),
                           NTW, C::DQ_SMEM, stream>>>(tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma<DP><<<dim3(unsigned((a.T + BKB - 1) / BKB),
                                  unsigned(p.Hkv), unsigned(B)),
                             KV_NT, C::KV_SMEM, stream>>>(tq, tk, tv, tdo,
                                                          p);
  return cudaGetLastError();
}

// what TMA can describe: D and every stride a multiple of 8 elements (16
// bytes) and none 0, bases 16-byte aligned (kernel.py: route)
bool tma_ok(const void* const* ptrs, int n, const int64_t* strides, int m,
            int64_t D) {
  uintptr_t all_p = 0;
  for (int i = 0; i < n; ++i) all_p |= reinterpret_cast<uintptr_t>(ptrs[i]);
  int64_t all_s = D;
  for (int i = 0; i < m; ++i) {
    if (strides[i] <= 0) return false;
    all_s |= strides[i];
  }
  return all_p % 16 == 0 && all_s % 8 == 0;
}

bool shape_ok(int64_t B, int64_t T, int64_t H, int64_t Hkv, int64_t D,
              int64_t Tp, int window) {
  return B > 0 && T > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && D > 32 &&
         D <= 128 && T <= INT32_MAX - 128 && B <= 65535 && H <= 65535 &&
         window >= 0 && Tp >= T && Tp % BQW == 0;
}

}  // namespace

extern "C" {

// The forward with the lse saved (flash_fwd_wgmma<DP, true>): o and its
// residual o_lo (B, T, H, D) bf16 contiguous, lse (B, H, Tp) fp32, Tp = T
// rounded up to 128.
// Returns a cudaError_t, 0 on success; cudaErrorInvalidValue for what the
// kernels do not take or a head dim this build does not hold.
int flash_attention_train_fwd(const void* q, const void* k, const void* v,
                              void* o, void* o_lo, float* lse, int64_t B,
                              int64_t T,
                              int64_t H, int64_t Hkv, int64_t D, int64_t Tp,
                              int64_t qsb, int64_t qst, int64_t qsh,
                              int64_t ksb, int64_t kst, int64_t ksh,
                              int64_t vsb, int64_t vst, int64_t vsh,
                              int causal, int window, float scale,
                              void* stream) {
  const void* ptrs[] = {q, k, v};
  const int64_t strides[] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  if (!shape_ok(B, T, H, Hkv, D, Tp, window) ||
      !tma_ok(ptrs, 3, strides, 9, D))
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, o, int(T), int(H), int(H / Hkv), int(D), qsb, qst,
               qsh, ksb, kst, ksh, vsb, vst, vsh, causal, window, scale,
               lse, int(Tp), o_lo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if FLASH_TRAIN_64
  if (D <= 64) return int(launch_wgmma_dp<64, true>(a, B, Hkv, s));
#endif
#if FLASH_TRAIN_128
  if (D > 64) return int(launch_wgmma_dp<128, true>(a, B, Hkv, s));
#endif
  return int(cudaErrorInvalidValue);
}

// The backward: dq (B, T, H, D), dk and dv (B, T, Hkv, D), bf16 contiguous,
// from q, k, v, the forward's o, o_lo and lse, and dO (strides in elements);
// delta is (B, H, Tp) fp32 scratch.  Three launches on `stream`: delta,
// dq, dk and dv.
int flash_attention_train_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* o_lo,
                              const float* lse, const void* dout,
                              float* delta, void* dq,
                              void* dk, void* dv, int64_t B, int64_t T,
                              int64_t H, int64_t Hkv, int64_t D, int64_t Tp,
                              int64_t qsb, int64_t qst, int64_t qsh,
                              int64_t ksb, int64_t kst, int64_t ksh,
                              int64_t vsb, int64_t vst, int64_t vsh,
                              int64_t dsb, int64_t dst, int64_t dsh,
                              int causal, int window, float scale,
                              void* stream) {
  const void* ptrs[] = {q, k, v, dout, lse, delta};
  const int64_t strides[] = {qsb, qst, qsh, ksb, kst, ksh,
                             vsb, vst, vsh, dsb, dst, dsh};
  if (!shape_ok(B, T, H, Hkv, D, Tp, window) ||
      !tma_ok(ptrs, 6, strides, 12, D))
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, const_cast<void*>(o), int(T), int(H), int(H / Hkv),
               int(D), qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, causal,
               window, scale, const_cast<float*>(lse), int(Tp)};
  const Bwd p{a, o_lo, dout, dsb, dst, dsh, delta, dq, dk, dv, int(Hkv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if FLASH_TRAIN_64
  if (D <= 64) return int(launch_bwd<64>(p, B, s));
#endif
#if FLASH_TRAIN_128
  if (D > 64) return int(launch_bwd<128>(p, B, s));
#endif
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
