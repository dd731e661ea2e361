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
// FlashAttention-2's backward in three kernels on one stream, with no
// floating-point atomics, so two launches give the same bits:
//
// 1. delta_kernel: D (B, H, Sq) in fp32, one warp per row.
// 2. dkdv_kernel: one CTA per (b, query head, block of kBK kv rows); it
//    keeps that block's k and v in shared memory and its dK and dV in
//    registers, and walks the q blocks that can see it (from the causal
//    edge to the window's end). Each head writes its own fp32 partial
//    (B, H, Skv, hd); group_sum_kernel adds the heads of each kv group in
//    head order and writes dK and dV in the inputs' type. (One CTA per kv
//    head looping over the group would need no partials but leave the
//    card idle at MQA: gemma-2b has 1 kv head, so 64 CTAs.)
// 3. dq_kernel: one CTA per (b, head, block of kBQ q rows), its dQ in
//    registers, walking the kv blocks from the window's start to the
//    causal edge.
//
// fp32 and bf16 inputs; every product and sum in fp32, outputs rounded once
// to the inputs' type. q, k, v and o may be strided (B, heads, S, hd) views
// with the hd axis contiguous; dO too. Head dims 16, 32, 64, 128, 256.
//
// What bounds it on this card: operations. At gemma-2b's train shape (q
// (2, 8, 2048, 256), k and v (2, 1, 2048, 256), causal) the backward's five
// products over the causal half are 2.5x the forward's 34.4 GFLOP, 86
// GFLOP: 0.087 ms at the 989 TFLOP/s bf16 peak of the tensor cores. This
// first version runs on the fp32 cores (67 TFLOP/s: 1.28 ms at best) and
// recomputes S and dP in both kernels (seven products); the tiles sit in
// shared memory as fp32 (row padded by 4 floats, so float4 reads meet no
// bank conflict), each thread owns a micro-tile of scores and a strip of
// output columns. A wgmma/TMA design for bf16 is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, h, s;
};

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
             float* __restrict__ D, int H, int Sq, long long nrows,
             Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= nrows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / ((long long)H * Sq);
  const int h = (int)(row / Sq % H);
  const int i = (int)(row % Sq);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) D[row] = acc;
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
      (const T*)o, (const T*)dO, D, H, Sq, nrows, os, dos);
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

  const long long per_head = (long long)Skv * HD;
  const long long n = (long long)B * KV * per_head;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long sblocks = want < 8192 ? want : 8192;
  group_sum_kernel<T><<<(unsigned)sblocks, kThreads, 0, stream>>>(
      dk_part, dv_part, (T*)dk, (T*)dv, H, KV, per_head, n);
  err = cudaGetLastError();
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

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* o, const void* dO, const float* lse, void* dq,
                void* dk, void* dv, float* D, float* dk_part, float* dv_part,
                int B, int H, int KV, int Sq, int Skv, int window, float scale,
                Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                cudaStream_t s) {
#define FA_BWD_CASE(N)                                                      \
  case N:                                                                   \
    return launch<T, N>(q, k, v, o, dO, lse, dq, dk, dv, D, dk_part,        \
                        dv_part, B, H, KV, Sq, Skv, window, scale, qs, ks,  \
                        vs, os, dos, s);
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

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, dO, and dq, dk, dv alike). q, k,
// v, o and dO are (B, heads, S, hd) views with these element strides and
// the hd axis contiguous; lse (B, H, Sq) fp32 from the forward. dq (B, H,
// Sq, hd) and dk, dv (B, KV, Skv, hd) are written contiguous. Scratch from
// the caller: D (B, H, Sq) and dk_part, dv_part (B, H, Skv, hd), fp32.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv, void* D,
    void* dk_part, void* dv_part, int dtype, int B, int H, int KV, int Sq,
    int Skv, int hd, int window, float scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long d_sb, long long d_sh,
    long long d_ss, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss}, dos{d_sb, d_sh, d_ss};
  cudaStream_t s = (cudaStream_t)stream;
  float* Df = (float*)D;
  float* kp = (float*)dk_part;
  float* vp = (float*)dv_part;
  const float* l = (const float*)lse;
  if (dtype == 0) {
    return dispatch_hd<float>(hd, q, k, v, o, dO, l, dq, dk, dv, Df, kp, vp,
                              B, H, KV, Sq, Skv, window, scale, qs, ks, vs,
                              os, dos, s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dO, l, dq, dk, dv, Df,
                                      kp, vp, B, H, KV, Sq, Skv, window, scale,
                                      qs, ks, vs, os, dos, s);
  }
  return (int)cudaErrorInvalidValue;
}
