// The backward of the fused causal attention (csrc/flash_attention.cu), with
// GQA/MQA and an optional sliding window, hand-written for Hopper.
//
// Replaces: nothing on the TPU. The TPU kernel
// (src/repro/kernels/flash_attention.py, flash_attention_pallas) has no
// backward: the JAX package trains through the jnp blockwise_attention.
// The port runs the forward kernel in train mode, so its gradient is a
// kernel too.
//
// Given q, k, v, the forward's output o and its fp32 row log-sum-exp
// lse_i = ln sum_j exp(s_ij), and dO:
//
//     p_ij  = exp(s_ij - lse_i) where j is visible to i, else 0
//     D_i   = sum_d dO_id o_id
//     dV_j  = sum_{i, heads of the group} p_ij dO_i
//     dS_ij = p_ij (dO_i . v_j - D_i)
//     dQ_i  = scale sum_j dS_ij k_j
//     dK_j  = scale sum_{i, heads of the group} dS_ij q_i
//
// with s_ij = scale q_i . k_j, the forward's masking rule (j <= i, and
// i - j < window when window > 0) and its positions from 0 in q and kv.
// Masked pairs and rows that see nothing get zero gradient, as they give
// zero output.
//
// FlashAttention-2's backward, with no floating-point atomics (two launches
// give the same bits), in four kernels on one stream:
//
// 1. delta_kernel: D (B, H, Sq) in fp32, one warp per row (bound by bytes).
// 2. dK/dV: one CTA per (b, query head, block of kv rows), keeping that
//    block's k and v in shared memory and its dK and dV in registers,
//    walking the q blocks that can see it (from the causal edge to the
//    window's end). Each head writes its own fp32 partial (B, H, Skv, hd);
// 3. group_sum_kernel adds the heads of each kv group in head order and
//    writes dK and dV in the inputs' type. (One CTA per kv head looping over
//    the group would need no partials but leave the card idle at MQA:
//    gemma-2b has 1 kv head, so 64 CTAs.)
// 4. dQ: one CTA per (b, head, block of q rows), its dQ in registers,
//    walking the kv blocks from the window's start to the causal edge.
//
// Two routes, by the inputs' type (flash_attention_bwd_launch), as in the
// forward: a route by type, not a fallback; a bf16 call the tensor-core
// kernels cannot take is refused, never sent to the SIMT ones. q, k, v, o
// and dO may be strided (B, heads, S, hd) views with the hd axis
// contiguous. Head dims 16, 32, 64, 128, 256.
//
// What bounds it on this card: operations. At gemma-2b's train shape (q
// (2, 8, 2048, 256), k and v (2, 1, 2048, 256), causal) the backward's five
// products over the causal half are 2.5x the forward's 34.4 GFLOP, 86
// GFLOP: 0.087 ms at the 989 TFLOP/s bf16 peak of the tensor cores.
//
// * bf16: dkdv_tc_kernel and dq_tc_kernel on the tensor cores, built from
//   the forward's parts (hopper.cuh): a producer warpgroup whose one thread
//   issues every TMA copy (4-D maps over the views' own strides, swizzled
//   panels) into mbarrier rings and hands its registers to two consumer
//   warpgroups (setmaxnreg 24 / 240), which run wgmma. The rounding: S and
//   dP are fp32 sums of bf16 products; P and dS, the A operands of the
//   second products, are each split into a bf16 high part and a bf16 low
//   part (hi = bf16(x), lo = bf16(x - hi)) and each such product runs
//   twice on the same B tile, every sum in fp32, the outputs rounded once.
//   A single bf16 rounding of P or dS misses the bf16 tolerance of the
//   checks at their own shapes (tests/test_torch_flash_bwd_rounding.py);
//   the split costs two more products' worth of tensor-core work (about 10
//   in all against 5: 0.17 ms at peak).
//   - dK/dV: a CTA owns 64 kv rows; a two-stage ring streams 64-row (q,
//     dO) tiles with their lse2 and D rows (bulk copies; lse2 = lse
//     log2(e), the forward's natural log converted once, padded). The
//     64 x HD fp32 dK and dV do not both fit one warpgroup's registers at
//     hd 256, so warpgroup 0 computes S^T = K Q^T, forms P^T and
//     accumulates dV += P^T dO, and passes P^T (fp32, 16 KB) to warpgroup 1
//     through shared memory under two named barriers; warpgroup 1 computes
//     dP^T = V dO^T, forms dS^T = P^T (dP^T - D) and accumulates dK +=
//     dS^T Q. Each: one ss product and two rs products (dO and Q read
//     MN-major through the transpose bit). At hd 256: k and v 64 KB, the
//     ring 128 KB, P^T 16 KB.
//   - dQ: a CTA owns 128 q rows, 64 a warpgroup (the forward's shape with
//     dP added): q and dO loaded once, kv tiles of 64 rows (32 at hd 256,
//     so that q, dO and a two-stage ring fit in 192 KB) through the ring;
//     per tile S = Q K^T and dP = dO V^T (ss), dS behind the mask, dQ +=
//     dS K (hi and lo, K MN-major). Tiles wholly masked for a warpgroup
//     are skipped (it still takes part in the ring); the longest CTAs run
//     first.
//   Scores are scaled in fp32 (hd^-0.5 is not a power of two at hd 128);
//   rows that see nothing have lse = -inf and get lse2 = +inf, so their p
//   is 0 even where the mask is not applied (no inf * 0).
// * fp32: dkdv_kernel and dq_kernel on the fp32 cores (the parity runs'
//   route): every product and sum in fp32, S and dP recomputed in both;
//   tiles of 32 rows at hd 256 (else 64) sit in shared memory as fp32 (row
//   padded by 4 floats, so float4 reads meet no bank conflict), each thread
//   owns a micro-tile of scores and a strip of output columns. Its roof is
//   1.28 ms at the 67 TFLOP/s fp32 peak.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Tiles: kB q rows and kB kv rows (32 at hd 256, where shared memory is
// the limit, else 64); rows padded to kLd floats.
template <int HD>
struct Cfg {
  static constexpr int kB = HD >= 256 ? 32 : 64;
  static constexpr int kLd = HD + 4;
  static constexpr int kM = kB / 16;              // micro-tile side
  static constexpr int kC4 = HD / 4;              // float4 columns
  static constexpr int kRG = kThreads / kC4;      // row groups of the strip
  static constexpr int kRows = kB / kRG;          // strip rows per thread
  static constexpr int kLdP = kB + 1;
  // shared memory, in floats: two row tiles that stay (the CTA's own
  // block), two that stream, p and dS, and lse and D of the q block
  static constexpr int kTile = kB * kLd;
  static constexpr int kFloats = 4 * kTile + 2 * kB * kLdP + 2 * kB;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(kThreads % kC4 == 0 && kB % kRG == 0, "strip layout");
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows row0 .. row0 + kB - 1 of a strided (S, hd) matrix into a padded fp32
// tile; rows at and past `limit` are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int limit) {
  using C = Cfg<HD>;
  for (int e = threadIdx.x; e < C::kB * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = row0 + r;
    dst[r * C::kLd + d] = s < limit ? to_f32(src[(long long)s * ss + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int window) {
  return qp < Sq && kp < Skv && kp <= qp && (window <= 0 || qp - kp < window);
}

// For a q tile (sq, sdo, with lse and D in sl, sd) and a kv tile (sk, sv)
// at rows q0 and kv0: p and dS into sp and sds (kB x kB, row = q). Thread t
// owns q rows t / 16 + 16 e and kv rows t % 16 + 16 c.
template <int HD>
__device__ __forceinline__ void p_and_ds(const float* sq, const float* sdo,
                                         const float* sk, const float* sv,
                                         const float* sl, const float* sd,
                                         float* sp, float* sds, int q0,
                                         int kv0, int Sq, int Skv, int window,
                                         float scale) {
  using C = Cfg<HD>;
  const int tq = threadIdx.x / 16;
  const int tk = threadIdx.x % 16;
  float s[C::kM][C::kM], dp[C::kM][C::kM];
#pragma unroll
  for (int e = 0; e < C::kM; ++e) {
#pragma unroll
    for (int c = 0; c < C::kM; ++c) s[e][c] = dp[e][c] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qa[C::kM], da[C::kM];
#pragma unroll
    for (int e = 0; e < C::kM; ++e) {
      qa[e] = *reinterpret_cast<const float4*>(sq + (tq + 16 * e) * C::kLd + d);
      da[e] = *reinterpret_cast<const float4*>(sdo + (tq + 16 * e) * C::kLd + d);
    }
#pragma unroll
    for (int c = 0; c < C::kM; ++c) {
      const float4 kb =
          *reinterpret_cast<const float4*>(sk + (tk + 16 * c) * C::kLd + d);
      const float4 vb =
          *reinterpret_cast<const float4*>(sv + (tk + 16 * c) * C::kLd + d);
#pragma unroll
      for (int e = 0; e < C::kM; ++e) {
        s[e][c] = fmaf(qa[e].x, kb.x, s[e][c]);
        s[e][c] = fmaf(qa[e].y, kb.y, s[e][c]);
        s[e][c] = fmaf(qa[e].z, kb.z, s[e][c]);
        s[e][c] = fmaf(qa[e].w, kb.w, s[e][c]);
        dp[e][c] = fmaf(da[e].x, vb.x, dp[e][c]);
        dp[e][c] = fmaf(da[e].y, vb.y, dp[e][c]);
        dp[e][c] = fmaf(da[e].z, vb.z, dp[e][c]);
        dp[e][c] = fmaf(da[e].w, vb.w, dp[e][c]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < C::kM; ++e) {
    const int qi = tq + 16 * e;
    const float l = sl[qi], dd = sd[qi];
#pragma unroll
    for (int c = 0; c < C::kM; ++c) {
      const int kj = tk + 16 * c;
      const bool ok = visible(q0 + qi, kv0 + kj, Sq, Skv, window);
      const float p = ok ? expf(s[e][c] * scale - l) : 0.f;
      sp[qi * C::kLdP + kj] = p;
      sds[qi * C::kLdP + kj] = p * (dp[e][c] - dd);
    }
  }
}

// D_i = sum_d dO_id o_id into D (B, H, ld), one warp per row; rows i in
// [Sq, ld) get 0. With lse2 (the bf16 route): lse2_i = lse_i log2(e), and
// +inf where lse_i = -inf (a row that sees nothing) and in the padded rows,
// so that exp2(s - lse2) is 0 there.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
             const float* __restrict__ lse, float* __restrict__ D,
             float* __restrict__ lse2, int H, int Sq, int ld,
             long long nrows, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= nrows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / ((long long)H * ld);
  const int h = (int)(row / ld % H);
  const int i = (int)(row % ld);
  if (i >= Sq) {
    if (lane == 0) {
      D[row] = 0.f;
      if (lse2 != nullptr) lse2[row] = INFINITY;
    }
    return;
  }
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    D[row] = acc;
    if (lse2 != nullptr) {
      const float l = lse[(b * H + h) * Sq + i];
      lse2[row] = l == -INFINITY ? INFINITY : l * kLog2e;
    }
  }
}

// dK and dV of one query head over kv rows kv0 .. kv0 + kB - 1, as fp32
// partials (B, H, Skv, hd)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ D,
            float* __restrict__ dk_part, float* __restrict__ dv_part, int H,
            int KV, int Sq, int Skv, int window, float scale, Strides qs,
            Strides ks, Strides vs, Strides dos) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + C::kTile;
  float* sq = sv + C::kTile;
  float* sdo = sq + C::kTile;
  float* sp = sdo + C::kTile;
  float* sds = sp + C::kB * C::kLdP;
  float* sl = sds + C::kB * C::kLdP;
  float* sd = sl + C::kB;

  const int kv0 = blockIdx.x * C::kB;       // longest CTAs first: block 0
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  q += b * qs.b + h * qs.h;
  dO += b * dos.b + h * dos.h;
  k += b * ks.b + kvh * ks.h;
  v += b * vs.b + kvh * vs.h;
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = D + ((long long)b * H + h) * Sq;

  load_tile<T, HD>(sk, k, ks.s, kv0, Skv);
  load_tile<T, HD>(sv, v, vs.s, kv0, Skv);

  // the strip this thread accumulates: rows j = jg + kRG m, float4 column dc
  const int dc = threadIdx.x % C::kC4;
  const int jg = threadIdx.x / C::kC4;
  float4 ak[C::kRows], av[C::kRows];
#pragma unroll
  for (int m = 0; m < C::kRows; ++m) {
    ak[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    av[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // q rows that can see some of kv0 .. kv0 + kB - 1: from kv0 (causal) to
  // kv0 + kB - 1 + window - 1 (window)
  const int kv_last = min(kv0 + C::kB, Skv) - 1;
  const int q_end = window > 0 ? min(Sq, kv_last + window) : Sq;
  for (int q0 = kv0 / C::kB * C::kB; q0 < q_end; q0 += C::kB) {
    __syncthreads();   // readers of the previous q tile are done
    load_tile<T, HD>(sq, q, qs.s, q0, Sq);
    load_tile<T, HD>(sdo, dO, dos.s, q0, Sq);
    for (int r = threadIdx.x; r < C::kB; r += kThreads) {
      const bool in = q0 + r < Sq;
      sl[r] = in ? lrow[q0 + r] : 0.f;
      sd[r] = in ? drow[q0 + r] : 0.f;
    }
    __syncthreads();
    p_and_ds<HD>(sq, sdo, sk, sv, sl, sd, sp, sds, q0, kv0, Sq, Skv, window,
                 scale);
    __syncthreads();
    // dV_j += sum_i p_ij dO_i, dK_j += sum_i dS_ij q_i
#pragma unroll 2
    for (int i = 0; i < C::kB; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(sdo + i * C::kLd + 4 * dc);
      const float4 x = *reinterpret_cast<const float4*>(sq + i * C::kLd + 4 * dc);
#pragma unroll
      for (int m = 0; m < C::kRows; ++m) {
        const int j = jg + C::kRG * m;
        const float p = sp[i * C::kLdP + j];
        const float ds = sds[i * C::kLdP + j];
        av[m].x = fmaf(p, g.x, av[m].x);
        av[m].y = fmaf(p, g.y, av[m].y);
        av[m].z = fmaf(p, g.z, av[m].z);
        av[m].w = fmaf(p, g.w, av[m].w);
        ak[m].x = fmaf(ds, x.x, ak[m].x);
        ak[m].y = fmaf(ds, x.y, ak[m].y);
        ak[m].z = fmaf(ds, x.z, ak[m].z);
        ak[m].w = fmaf(ds, x.w, ak[m].w);
      }
    }
  }

  const long long base = (((long long)b * H + h) * Skv) * HD;
#pragma unroll
  for (int m = 0; m < C::kRows; ++m) {
    const int j = kv0 + jg + C::kRG * m;
    if (j >= Skv) continue;
    float4 kk = ak[m];
    kk.x *= scale;
    kk.y *= scale;
    kk.z *= scale;
    kk.w *= scale;
    *reinterpret_cast<float4*>(dk_part + base + (long long)j * HD + 4 * dc) = kk;
    *reinterpret_cast<float4*>(dv_part + base + (long long)j * HD + 4 * dc) = av[m];
  }
}

// dK, dV (B, KV, Skv, hd) contiguous, in T: the group's partials added in
// head order
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ dk_part,
                 const float* __restrict__ dv_part, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int KV, long long per_head,
                 long long n) {
  const int G = H / KV;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long bk = e / per_head;         // b * KV + kv head
    const long long rest = e - bk * per_head;
    const long long b = bk / KV;
    const long long h0 = b * H + (bk - b * KV) * G;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += dk_part[(h0 + g) * per_head + rest];
      sv += dv_part[(h0 + g) * per_head + rest];
    }
    store(dk + e, sk);
    store(dv + e, sv);
  }
}

template <typename T, int HD>
cudaError_t group_sum(const float* dk_part, const float* dv_part, void* dk,
                      void* dv, int B, int H, int KV, int Skv,
                      cudaStream_t stream) {
  const long long per_head = (long long)Skv * HD;
  const long long n = (long long)B * KV * per_head;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long blocks = want < 8192 ? want : 8192;
  group_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      dk_part, dv_part, (T*)dk, (T*)dv, H, KV, per_head, n);
  return cudaGetLastError();
}

// dQ of one head over q rows q0 .. q0 + kB - 1, in T, (B, H, Sq, hd)
// contiguous
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, int H, int KV, int Sq, int Skv, int window,
          float scale, Strides qs, Strides ks, Strides vs, Strides dos) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + C::kTile;
  float* sk = sdo + C::kTile;
  float* sv = sk + C::kTile;
  float* sp = sv + C::kTile;
  float* sds = sp + C::kB * C::kLdP;
  float* sl = sds + C::kB * C::kLdP;
  float* sd = sl + C::kB;

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest CTAs first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * C::kB;
  q += b * qs.b + h * qs.h;
  dO += b * dos.b + h * dos.h;
  k += b * ks.b + kvh * ks.h;
  v += b * vs.b + kvh * vs.h;
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = D + ((long long)b * H + h) * Sq;

  load_tile<T, HD>(sq, q, qs.s, q0, Sq);
  load_tile<T, HD>(sdo, dO, dos.s, q0, Sq);
  for (int r = threadIdx.x; r < C::kB; r += kThreads) {
    const bool in = q0 + r < Sq;
    sl[r] = in ? lrow[q0 + r] : 0.f;
    sd[r] = in ? drow[q0 + r] : 0.f;
  }

  const int dc = threadIdx.x % C::kC4;
  const int ig = threadIdx.x / C::kC4;
  float4 aq[C::kRows];
#pragma unroll
  for (int m = 0; m < C::kRows; ++m) aq[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_last = min(q0 + C::kB, Sq) - 1;
  const int kv_end = min(q_last + 1, Skv);                  // causal edge
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kv0 = kv_begin / C::kB * C::kB; kv0 < kv_end; kv0 += C::kB) {
    __syncthreads();   // readers of the previous kv tile are done
    load_tile<T, HD>(sk, k, ks.s, kv0, Skv);
    load_tile<T, HD>(sv, v, vs.s, kv0, Skv);
    __syncthreads();
    p_and_ds<HD>(sq, sdo, sk, sv, sl, sd, sp, sds, q0, kv0, Sq, Skv, window,
                 scale);
    __syncthreads();
    // dQ_i += sum_j dS_ij k_j
#pragma unroll 2
    for (int j = 0; j < C::kB; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(sk + j * C::kLd + 4 * dc);
#pragma unroll
      for (int m = 0; m < C::kRows; ++m) {
        const float ds = sds[(ig + C::kRG * m) * C::kLdP + j];
        aq[m].x = fmaf(ds, kk.x, aq[m].x);
        aq[m].y = fmaf(ds, kk.y, aq[m].y);
        aq[m].z = fmaf(ds, kk.z, aq[m].z);
        aq[m].w = fmaf(ds, kk.w, aq[m].w);
      }
    }
  }

  T* out = dq + (((long long)b * H + h) * Sq) * HD;
#pragma unroll
  for (int m = 0; m < C::kRows; ++m) {
    const int i = q0 + ig + C::kRG * m;
    if (i >= Sq) continue;
    T* row = out + (long long)i * HD + 4 * dc;
    store(row + 0, aq[m].x * scale);
    store(row + 1, aq[m].y * scale);
    store(row + 2, aq[m].z * scale);
    store(row + 3, aq[m].w * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, void* dq, void* dk, void* dv,
           float* D, float* dk_part, float* dv_part, int B, int H, int KV,
           int Sq, int Skv, int window, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, Strides dos, cudaStream_t stream) {
  using C = Cfg<HD>;
  const long long nrows = (long long)B * H * Sq;
  const long long dblocks = (nrows + kThreads / 32 - 1) / (kThreads / 32);
  delta_kernel<T, HD><<<(unsigned)dblocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dO, nullptr, D, nullptr, H, Sq, Sq, nrows, os,
      dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kdkdv = dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 gkv((Skv + C::kB - 1) / C::kB, H, B);
  kdkdv<<<gkv, kThreads, C::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, D, dk_part,
      dv_part, H, KV, Sq, Skv, window, scale, qs, ks, vs, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = group_sum<T, HD>(dk_part, dv_part, dk, dv, B, H, KV, Skv, stream);
  if (err != cudaSuccess) return (int)err;

  auto kdq = dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 gq((Sq + C::kB - 1) / C::kB, H, B);
  kdq<<<gq, kThreads, C::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, D, (T*)dq, H,
      KV, Sq, Skv, window, scale, qs, ks, vs, dos);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcStages = 2;           // ring depth
constexpr int kTcConsumers = 256;      // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;
constexpr int kBarPFull = 1;           // named barriers of the P exchange
constexpr int kBarPFree = 2;
// lse2 and D are padded to a multiple of the dQ kernel's q block, so every
// 64-row piece of them is one aligned bulk copy
constexpr int kRowPad = 128;

// dK/dV: a CTA owns 64 kv rows of one (b, query head); q tiles of 64 rows
template <int HD>
struct DkvCfg : Panels<HD> {
  static constexpr int kTile = 64 * HD * 2;          // one 64-row bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;              // ring: Q[stage]
  static constexpr int kDO = kQ + kTcStages * kTile; // ring: dO[stage]
  static constexpr int kP = kDO + kTcStages * kTile; // P^T, fp32, 64 x 64
  static constexpr int kL = kP + 64 * 64 * 4;        // ring: lse2[stage][64]
  static constexpr int kD = kL + kTcStages * 256;    // ring: D[stage][64]
  static constexpr int kBar = kD + kTcStages * 256;
  // kv_full, full[stage], empty[stage]
  static constexpr int kBarBytes = 8 * (1 + 2 * kTcStages);
  static constexpr size_t kSmem = kBar + kBarBytes + 1024;   // + alignment
  static_assert(kSmem <= 232448, "dK/dV shared memory");
};

// dQ: a CTA owns 128 q rows (a warpgroup each 64) of one (b, head); kv
// tiles of kBN rows (32 at hd 256, where shared memory is the limit)
template <int HD>
struct DqCfg : Panels<HD> {
  static constexpr int kBN = HD >= 256 ? 32 : 64;
  static constexpr int kQBytes = 128 * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;           // ring: K[stage]
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBar = kV + kTcStages * kKVBytes;
  // q_full, k_full[stage], v_full[stage], empty[stage]
  static constexpr int kBarBytes = 8 * (1 + 3 * kTcStages);
  static constexpr size_t kSmem = kBar + kBarBytes + 1024;
  static_assert(kSmem <= 232448, "dQ shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Accumulator layout of wgmma m64nN (per warpgroup): warp w, lane l holds
// for rows 16 w + l / 4 (registers 4 j, 4 j + 1) and 16 w + l / 4 + 8
// (4 j + 2, 4 j + 3) the columns 8 j + 2 (l % 4) and + 1; the register-A
// fragment of m64k16 is the same layout over 16 columns.
//
// dK and dV of one query head over kv rows kv0 .. kv0 + 63, as fp32
// partials (B, H, Skv, hd). Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO;
// warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q. P^T
// goes from warpgroup 0 to 1 through shared memory, in fp32, in the
// accumulator's own layout (both warpgroups hold the same positions).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse2, const float* __restrict__ D,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int H, int KV, int Sq, int Sqp, int Skv, int window,
               float scale_log2, float scale) {
  using C = DkvCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;

  const int kv0 = blockIdx.x * 64;       // block 0 sees the most q rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // q rows that see some of the block: from kv0 (causal) to the window's end
  const int kv_last = min(kv0 + 64, Skv) - 1;
  const int q_end = window > 0 ? min(Sq, kv_last + window) : Sq;
  const int n_tiles = q_end > kv0 ? (q_end - kv0 + 63) / 64 : 0;
  const long long lrow = ((long long)b * H + h) * Sqp;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kTcConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    setmaxnreg_dec<kTcProducerRegs>();
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(kv_full, 2 * C::kTile);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_4d(smem + C::kK + p * 64 * C::kRowBytes, &tk, kv_full,
                    p * C::kPW, kv0, kvh, b);
        tma_load_4d(smem + C::kV + p * 64 * C::kRowBytes, &tv, kv_full,
                    p * C::kPW, kv0, kvh, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages) mbar_wait(empty + st, ((t / kTcStages) & 1) ^ 1);
        const int q0 = kv0 + 64 * t;
        mbar_expect_tx(full + st, 2 * C::kTile + 512);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(smem + C::kQ + st * C::kTile + p * 64 * C::kRowBytes,
                      &tq, full + st, p * C::kPW, q0, h, b);
          tma_load_4d(smem + C::kDO + st * C::kTile + p * 64 * C::kRowBytes,
                      &tdo, full + st, p * C::kPW, q0, h, b);
        }
        bulk_load(smem + C::kL + st * 256, lse2 + lrow + q0, 256, full + st);
        bulk_load(smem + C::kD + st * 256, D + lrow + q0, 256, full + st);
      }
    }
    return;
  }

  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_a = 16 * warp + lane / 4;       // kv rows, and row_a + 8
  const int col0 = 2 * (lane % 4);              // q columns col0 + 8 j (+1)
  const uint32_t a_base = smem_u32(smem + (wg == 0 ? C::kK : C::kV));
  float* sp = reinterpret_cast<float*>(smem + C::kP);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    const uint32_t ph = (t / kTcStages) & 1;
    const int q0 = kv0 + 64 * t;
    const uint32_t q_addr = smem_u32(smem + C::kQ + st * C::kTile);
    const uint32_t do_addr = smem_u32(smem + C::kDO + st * C::kTile);
    const float* sl = reinterpret_cast<const float*>(smem + C::kL + st * 256);
    const float* sd = reinterpret_cast<const float*>(smem + C::kD + st * 256);
    mbar_wait(full + st, ph);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 64 x 64
    const uint32_t b_base = wg == 0 ? q_addr : do_addr;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_m64n64(s, desc_kmajor<HD>(a_base, 64, 0, kk),
                      desc_kmajor<HD>(b_base, 64, 0, kk), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool need_mask = q0 < kv0 + 63 || kv0 + 64 > Skv ||
                           q0 + 64 > Sq ||
                           (window > 0 && q0 + 63 - kv0 >= window);
    if (wg == 0) {
      // P^T = exp2(S^T scale log2(e) - lse2), 0 where not visible
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + col0 + (i % 2);
        float p = exp2f(fmaf(s[i], scale_log2, -sl[qc]));
        if (need_mask) {
          const int kp = kv0 + row_a + ((i % 4) >= 2 ? 8 : 0);
          p = visible(q0 + qc, kp, Sq, Skv, window) ? p : 0.f;
        }
        s[i] = p;
      }
      if (t > 0) named_sync(kBarPFree, kTcConsumers);
#pragma unroll
      for (int i = 0; i < 32; ++i) sp[i * 128 + tid] = s[i];
      named_arrive(kBarPFull, kTcConsumers);
    } else {
      // dS^T = P^T (dP^T - D)
      named_sync(kBarPFull, kTcConsumers);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + col0 + (i % 2);
        s[i] = sp[i * 128 + tid] * (s[i] - sd[qc]);
      }
      if (t + 1 < n_tiles) named_arrive(kBarPFree, kTcConsumers);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): the A
    // operand as its bf16 high part and then its low part, every sum in
    // fp32; dO and Q MN-major
    uint32_t ahi[16], alo[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) split_bf16(s[2 * j], s[2 * j + 1], ahi[j], alo[j]);
    const uint32_t m_base = wg == 0 ? do_addr : q_addr;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<HD>(acc, ahi + 4 * kk, desc_mnmajor<HD>(m_base, 64, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<HD>(acc, alo + 4 * kk, desc_mnmajor<HD>(m_base, 64, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + st);
  }

  float* out = (wg == 0 ? dv_part : dk_part) + ((long long)b * H + h) * Skv * HD;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kv0 + row_a + 8 * r;
    if (j >= Skv) continue;
    float* row = out + (long long)j * HD + col0;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      *reinterpret_cast<float2*>(row + 8 * c) =
          make_float2(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
  }
}

// dQ (B, H, Sq, hd) bf16 of one head over q rows q0 .. q0 + 127; each
// consumer warpgroup owns 64 of them and walks the kv tiles from the
// window's start to the causal edge: S = Q K^T and dP = dO V^T, dS = P (dP
// - D), dQ += dS K with dS as its bf16 high and low parts and K MN-major
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse2, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq, int Sqp,
             int Skv, int window, float scale_log2, float scale) {
  using C = DqCfg<HD>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest CTAs first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * 128;
  const int q_last = min(q0 + 128, Sq) - 1;
  const int kv_end = min(q_last + 1, Skv);                 // causal edge
  const int kv_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BN * BN;
  const int n_tiles = kv_end > kv_first ? (kv_end - kv_first + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, kTcConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    setmaxnreg_dec<kTcProducerRegs>();
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(q_full, 2 * C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_4d(smem + C::kQ + p * 128 * C::kRowBytes, &tq, q_full,
                    p * C::kPW, q0, h, b);
        tma_load_4d(smem + C::kDO + p * 128 * C::kRowBytes, &tdo, q_full,
                    p * C::kPW, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages) mbar_wait(empty + st, ((t / kTcStages) & 1) ^ 1);
        const int kv0 = kv_first + t * BN;
        mbar_expect_tx(k_full + st, C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(smem + C::kK + st * C::kKVBytes + p * BN * C::kRowBytes,
                      &tk, k_full + st, p * C::kPW, kv0, kvh, b);
        }
        mbar_expect_tx(v_full + st, C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(smem + C::kV + st * C::kKVBytes + p * BN * C::kRowBytes,
                      &tv, v_full + st, p * C::kPW, kv0, kvh, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq0 = q0 + 64 * wg;
  const int row_a = 16 * warp + lane / 4;       // and row_a + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(smem + C::kQ);
  const uint32_t do_addr = smem_u32(smem + C::kDO);
  const long long lrow = ((long long)b * H + h) * Sqp + wq0 + row_a;
  const float ls[2] = {lse2[lrow], lse2[lrow + 8]};
  const float dd[2] = {D[lrow], D[lrow + 8]};

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    const uint32_t ph = (t / kTcStages) & 1;
    const int kv0 = kv_first + t * BN;
    const bool skip = wq0 >= Sq || kv0 > wq0 + 63 ||
                      (window > 0 && wq0 - (kv0 + BN - 1) >= window);
    mbar_wait(k_full + st, ph);
    if (skip) {                     // wholly masked for this warpgroup
      mbar_wait(v_full + st, ph);
      mbar_arrive(empty + st);
      continue;
    }
    const uint32_t k_addr = smem_u32(smem + C::kK + st * C::kKVBytes);
    const uint32_t v_addr = smem_u32(smem + C::kV + st * C::kKVBytes);
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<BN>(s, desc_kmajor<HD>(q_addr, 128, 64 * wg, kk),
                   desc_kmajor<HD>(k_addr, BN, 0, kk), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    mbar_wait(v_full + st, ph);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<BN>(dp, desc_kmajor<HD>(do_addr, 128, 64 * wg, kk),
                   desc_kmajor<HD>(v_addr, BN, 0, kk), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - D), P = exp2(S scale log2(e) - lse2), 0 where not visible
    const bool need_mask = kv0 + BN - 1 > wq0 || kv0 + BN > Skv ||
                           (window > 0 && wq0 + 63 - kv0 >= window);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i % 4) >> 1;
      float p = exp2f(fmaf(s[i], scale_log2, -ls[r]));
      if (need_mask) {
        const int qp = wq0 + row_a + 8 * r;
        const int kp = kv0 + 8 * (i / 4) + col0 + (i % 2);
        const bool ok = kp <= qp && kp < Skv && (window <= 0 || qp - kp < window);
        p = ok ? p : 0.f;
      }
      s[i] = p * (dp[i] - dd[r]);
    }
    uint32_t ahi[BN / 4], alo[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) split_bf16(s[2 * j], s[2 * j + 1], ahi[j], alo[j]);

    // dQ += dS K: K (BN x HD) MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs<HD>(acc, ahi + 4 * kk, desc_mnmajor<HD>(k_addr, BN, kk));
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs<HD>(acc, alo + 4 * kk, desc_mnmajor<HD>(k_addr, BN, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + st);
  }

  __nv_bfloat16* out = dq + ((long long)b * H + h) * Sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq0 + row_a + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* row = out + (long long)qp * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dO, const float* lse, void* dq, void* dk, void* dv,
              float* D, float* lse2, float* dk_part, float* dv_part, int B,
              int H, int KV, int Sq, int Skv, int window, float scale,
              Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
              cudaStream_t stream) {
  using Ckv = DkvCfg<HD>;
  using Cq = DqCfg<HD>;
  const int Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  CUtensorMap tq64, tdo64, tk64, tv64, tq128, tdo128, tkn, tvn;
  if (!tensor_map<HD>(&tq64, q, B, H, Sq, qs, 64) ||
      !tensor_map<HD>(&tdo64, dO, B, H, Sq, dos, 64) ||
      !tensor_map<HD>(&tk64, k, B, KV, Skv, ks, 64) ||
      !tensor_map<HD>(&tv64, v, B, KV, Skv, vs, 64) ||
      !tensor_map<HD>(&tq128, q, B, H, Sq, qs, 128) ||
      !tensor_map<HD>(&tdo128, dO, B, H, Sq, dos, 128) ||
      !tensor_map<HD>(&tkn, k, B, KV, Skv, ks, Cq::kBN) ||
      !tensor_map<HD>(&tvn, v, B, KV, Skv, vs, Cq::kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nrows = (long long)B * H * Sqp;
  const long long dblocks = (nrows + kThreads / 32 - 1) / (kThreads / 32);
  delta_kernel<__nv_bfloat16, HD><<<(unsigned)dblocks, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dO, lse, D, lse2, H, Sq,
      Sqp, nrows, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float scale_log2 = scale * kLog2e;
  auto kdkdv = dkdv_tc_kernel<HD>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Ckv::kSmem);
  if (err != cudaSuccess) return (int)err;
  kdkdv<<<dim3((Skv + 63) / 64, H, B), kTcThreads, Ckv::kSmem, stream>>>(
      tq64, tk64, tv64, tdo64, lse2, D, dk_part, dv_part, H, KV, Sq, Sqp, Skv,
      window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = group_sum<__nv_bfloat16, HD>(dk_part, dv_part, dk, dv, B, H, KV, Skv,
                                     stream);
  if (err != cudaSuccess) return (int)err;

  auto kdq = dq_tc_kernel<HD>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cq::kSmem);
  if (err != cudaSuccess) return (int)err;
  kdq<<<dim3((Sq + 127) / 128, H, B), kTcThreads, Cq::kSmem, stream>>>(
      tq128, tkn, tvn, tdo128, lse2, D, (__nv_bfloat16*)dq, H, KV, Sq, Sqp,
      Skv, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dO, const float* lse, void* dq,
              void* dk, void* dv, float* D, float* lse2, float* dk_part,
              float* dv_part, int B, int H, int KV, int Sq, int Skv,
              int window, float scale, Strides qs, Strides ks, Strides vs,
              Strides os, Strides dos, cudaStream_t s) {
  if (dtype == 0) {
    return launch<float, HD>(q, k, v, o, dO, lse, dq, dk, dv, D, dk_part,
                             dv_part, B, H, KV, Sq, Skv, window, scale, qs,
                             ks, vs, os, dos, s);
  }
  if (dtype == 1) {
    return launch_tc<HD>(q, k, v, o, dO, lse, dq, dk, dv, D, lse2, dk_part,
                         dv_part, B, H, KV, Sq, Skv, window, scale, qs, ks,
                         vs, os, dos, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 (the SIMT kernels), 1 = bf16 (the tensor-core kernels):
// q, k, v, o, dO, and dq, dk, dv alike. q, k, v, o and dO are (B, heads,
// S, hd) views with these element strides and the hd axis contiguous; for
// bf16, q, k, v and dO start 16-byte aligned with strides that are
// multiples of 8 (TMA's rule). lse (B, H, Sq) fp32 from the forward. dq (B,
// H, Sq, hd) and dk, dv (B, KV, Skv, hd) are written contiguous. Scratch
// from the caller, fp32: dk_part, dv_part (B, H, Skv, hd); D (B, H, Sq)
// for fp32, and for bf16 D and lse2 (B, H, Sqp) with Sqp = Sq rounded up to
// a multiple of 128 (lse2 is null for fp32).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv, void* D,
    void* lse2, void* dk_part, void* dv_part, int dtype, int B, int H,
    int KV, int Sq, int Skv, int hd, int window, float scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long d_sb,
    long long d_sh, long long d_ss, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || H > 65535 || B > 65535 ||
      (dtype == 1) != (lse2 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss}, dos{d_sb, d_sh, d_ss};
  cudaStream_t s = (cudaStream_t)stream;
  float* Df = (float*)D;
  float* l2 = (float*)lse2;
  float* kp = (float*)dk_part;
  float* vp = (float*)dv_part;
  const float* l = (const float*)lse;
#define FA_BWD_CASE(N)                                                      \
  case N:                                                                   \
    return launch_hd<N>(dtype, q, k, v, o, dO, l, dq, dk, dv, Df, l2, kp,   \
                        vp, B, H, KV, Sq, Skv, window, scale, qs, ks, vs,   \
                        os, dos, s);
  switch (hd) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}
