// Fused causal attention with GQA/MQA and an optional sliding window,
// hand-written for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (kernel body _flash_kernel), the TPU kernel of the model's attention.
//
//     out[b, h, i] = sum_j p_ij v[b, h / (H / KV), j] / max(sum_j p_ij, 1e-20)
//     p_ij = exp(s_ij - m_i) where j <= i (and i - j < window when
//            window > 0), else 0;  s_ij = hd^-0.5 * (q_i . k_j)
//
// Positions count from 0 in q and in kv alike, as in the TPU kernel. m, l
// and the output accumulator are fp32 and the output is written in the
// input type. Masked scores get p = 0, so rows with nothing visible give 0.
// Unlike the TPU kernel, any Sq and Skv are taken: the ragged edges are
// masked here, not padded by the caller. Inputs may be strided views (the
// model's (B, S, H, hd) layout seen as (B, H, S, hd)); the hd axis must be
// contiguous.
//
// Two kernels, routed by the inputs' type (flash_attention_launch): it is
// a route by type, not a fallback, and a bf16 call the tensor-core kernel
// cannot take is refused, never sent to the other one. In training both
// also write the fp32 row log-sum-exp ln sum_j exp(s_ij) (B, H, Sq), -inf
// for a row that sees nothing, for the backward (flash_attention_bwd.cu);
// serving passes a null pointer and skips that store.
//
// * bf16: flash_attention_tc_kernel, on the tensor cores. What bounds it:
//   operations. At gemma-2b's prefill shape (B=4, H=8, KV=1, S=2048,
//   hd=256) the causal half of the two products is about 69 GFLOP against
//   75 MB of q, k, v and out: about 0.07 ms at the 989 TFLOP/s bf16 peak,
//   0.02 ms of bytes. Design: a CTA owns 128 q rows of one (batch, head)
//   as two consumer warpgroups of 64 rows and one producer warpgroup,
//   which hands its registers to them (setmaxnreg: 24 against 240, so the
//   64 x 256 fp32 accumulator stays in registers). The producer's one
//   issuing thread loads the q block once and streams 64-row k and v tiles
//   through a two-stage ring in shared memory with TMA
//   (cp.async.bulk.tensor, 4-D maps over (hd, S, heads, B) with the
//   views' own strides; rows past the end come back as zeros), each
//   completion on an mbarrier, each stage released by the consumers
//   through another: the next tile's load overlaps this tile's products.
//   Tiles land in 32/64/128-byte swizzled panels of at most 64 columns,
//   the layouts the wgmma descriptors name. Per tile, each warpgroup runs
//   S = Q K^T as wgmma m64n64k16 with both operands in shared memory
//   (K-major), scales S by hd^-0.5 in fp32 (not q in bf16: the scale is
//   not a power of two at hd 128), masks, and updates the online softmax
//   in registers (exp2 with log2(e) folded into the scale); p is rounded
//   to bf16 in registers, the one new rounding, and O += P V runs as
//   wgmma m64n{hd}k16 with P from registers and V read through the
//   transpose bit (MN-major). Tiles wholly masked for a warpgroup are
//   skipped (it still takes part in the ring), and q blocks run from the
//   last to the first, so the longest CTAs start first.
//
// * fp32: flash_attention_kernel on the fp32 cores (this file's first
//   kernel, unchanged). At the shape above its roof is about 1 ms at the
//   67 TFLOP/s fp32 peak. One CTA owns one (batch, head, 64-row q block)
//   and loops over the 64-row kv tiles from the window's first tile to the
//   causal edge, so the online-softmax carry (m, l, acc) never leaves the
//   CTA; tiles that are wholly masked are skipped, which changes no bit (m
//   is unchanged there, the correction is exp(0) = 1 and p is 0). The q
//   blocks run from the last to the first. The q block (pre-scaled by
//   hd^-0.5), one k tile and one v tile sit in shared memory as fp32
//   (about 210 KB at hd 256); the query head reads its kv head through the
//   index h / (H / KV), so grouped heads share k and v without a broadcast
//   copy. Each of the 8 warps owns 8 q rows: for the scores, lane l holds
//   kv columns l and l + 32 of its 8 rows (q read as broadcast float4s, k
//   rows padded by 4 floats so the float4 reads meet no bank conflict); the
//   row max and sum are warp shuffles; p goes through shared memory to the
//   p.v product, where lane l owns the output columns l, l + 32, ... of its
//   8 rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;                // q rows per CTA
constexpr int kBK = 64;                // kv rows per tile
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;    // q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD>
struct Layout {
  static constexpr int kLd = HD + 4;   // padded row of q and k
  static constexpr int kNC = HD >= 32 ? HD / 32 : 1;   // out columns / lane
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd;
  static constexpr int kV = kK + kBK * kLd;
  static constexpr int kP = kV + kBK * HD;
  static constexpr int kFloats = kP + kBQ * kBK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long ss, int row0, int nrows,
                                          int limit, float mul) {
  for (int e = threadIdx.x; e < nrows * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = row0 + r;
    dst[r * ld + d] = s < limit ? to_f32(src[(long long)s * ss + d]) * mul : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int KV, int Sq,
                       int Skv, int window, float scale, Strides qs,
                       Strides ks, Strides vs, Strides os) {
  using Lay = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem + Lay::kQ;
  float* sk = smem + Lay::kK;
  float* sv = smem + Lay::kV;
  float* sp = smem + Lay::kP;

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest CTAs first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRows;

  q += b * qs.b + h * qs.h;
  o += b * os.b + h * os.h;
  k += b * ks.b + kvh * ks.h;
  v += b * vs.b + kvh * vs.h;

  load_tile<T, HD>(sq, Lay::kLd, q, qs.s, q0, kBQ, Sq, scale);

  float m[kRows], l[kRows], acc[kRows][Lay::kNC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < Lay::kNC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = min(q_last + 1, Skv);           // causal edge
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kv0 = kv_begin / kBK * kBK; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();   // every reader of the previous tile is done
    load_tile<T, HD>(sk, Lay::kLd, k, ks.s, kv0, kBK, Skv, 1.f);
    load_tile<T, HD>(sv, HD, v, vs.s, kv0, kBK, Skv, 1.f);
    __syncthreads();

    // scores: lane owns kv columns lane and lane + 32 of the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = sk + lane * Lay::kLd;
    const float* k1 = sk + (lane + 32) * Lay::kLd;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k0 + d);
      const float4 c = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(sq + (row0 + r) * Lay::kLd + d);
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, c.x, s[r][1]);
        s[r][1] = fmaf(x.y, c.y, s[r][1]);
        s[r][1] = fmaf(x.z, c.z, s[r][1]);
        s[r][1] = fmaf(x.w, c.w, s[r][1]);
      }
    }

    // mask, online softmax, p to shared memory
    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kp = kv0 + lane + 32 * t;
        ok[t] = kp <= qp && kp < Skv && (window <= 0 || qp - kp < window);
        if (!ok[t]) s[r][t] = kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      corr[r] = expf(m[r] - m_new);
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * corr[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      sp[(row0 + r) * kBK + lane] = p0;
      sp[(row0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc = acc * corr + p . v; lane owns columns lane + 32 c
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < Lay::kNC; ++c) acc[r][c] *= corr[r];
    }
    if (HD >= 32 || lane < HD) {
#pragma unroll 1
      for (int j = 0; j < kBK; j += 4) {
        float vv[4][Lay::kNC];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int c = 0; c < Lay::kNC; ++c) {
            vv[t][c] = sv[(j + t) * HD + lane + 32 * c];
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(sp + (row0 + r) * kBK + j);
#pragma unroll
          for (int c = 0; c < Lay::kNC; ++c) {
            acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
            acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
            acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
            acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
          }
        }
      }
    }
    __syncwarp();
  }

  if (HD >= 32 || lane < HD) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      if (qp >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int c = 0; c < Lay::kNC; ++c) {
        store(o + (long long)qp * os.s + lane + 32 * c, acc[r][c] * inv);
      }
    }
  }
  if (lse != nullptr && lane == 0) {   // training: the backward's input
    float* lrow = lse + ((long long)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      if (qp < Sq) lrow[qp] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Skv, int window, float scale,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<HD>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, Layout<HD>::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, KV, Sq, Skv,
      window, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Skv, int window,
                float scale,
                Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;             // q rows per CTA: two warpgroups of 64
constexpr int kTcBN = 64;              // kv rows per tile
constexpr int kTcStages = 2;           // k / v ring depth
constexpr int kTcConsumers = 256;      // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;

template <int HD>
struct TcCfg : Panels<HD> {
  static constexpr int kQBytes = kTcBM * HD * 2;
  static constexpr int kKVBytes = kTcBN * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBar = kV + kTcStages * kKVBytes;
  // q_full, k_full[S], v_full[S], empty[S]
  static constexpr int kBarBytes = 8 * (1 + 3 * kTcStages);
  static constexpr size_t kSmem = kBar + kBarBytes + 1024;   // + alignment
};

// Accumulator layout of wgmma m64nN (per warpgroup): warp w, lane l holds
// for rows 16 w + l / 4 (registers 4 j, 4 j + 1) and 16 w + l / 4 + 8
// (4 j + 2, 4 j + 3) the columns 8 j + 2 (l % 4) and + 1. The register-A
// fragment of m64k16 is the same layout over 16 columns, so P goes from
// the S accumulator to the A operand without leaving the registers.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int KV, int Sq,
                          int Skv, int window, float scale_log2,
                          Strides os) {
  using C = TcCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem + C::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest CTAs first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * kTcBM;
  const int q_last = min(q0 + kTcBM, Sq) - 1;
  const int kv_end = min(q_last + 1, Skv);                 // causal edge
  const int kv_first =
      (window > 0 ? max(0, q0 - window + 1) : 0) / kTcBN * kTcBN;
  const int n_tiles =
      kv_end > kv_first ? (kv_end - kv_first + kTcBN - 1) / kTcBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // producer warpgroup: gives up its registers; one thread issues every
    // copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kTcProducerRegs));
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_4d(sq + p * kTcBM * C::kRowBytes, &tq, q_full, p * C::kPW,
                    q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages) mbar_wait(empty + st, ((t / kTcStages) & 1) ^ 1);
        const int kv0 = kv_first + t * kTcBN;
        uint8_t* sk = smem + C::kK + st * C::kKVBytes;
        uint8_t* sv = smem + C::kV + st * C::kKVBytes;
        mbar_expect_tx(k_full + st, C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(sk + p * kTcBN * C::kRowBytes, &tk, k_full + st,
                      p * C::kPW, kv0, kvh, b);
        }
        mbar_expect_tx(v_full + st, C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(sv + p * kTcBN * C::kRowBytes, &tv, v_full + st,
                      p * C::kPW, kv0, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows wq0 .. wq0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kTcConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq0 = q0 + 64 * wg;
  const int row_a = 16 * warp + lane / 4;       // and row_a + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * C::kRowBytes;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};      // this thread's part of the row sums

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    const uint32_t ph = (t / kTcStages) & 1;
    const int kv0 = kv_first + t * kTcBN;
    const bool skip = kv0 > wq0 + 63 ||
                      (window > 0 && wq0 - (kv0 + kTcBN - 1) >= window);
    mbar_wait(k_full + st, ph);
    if (skip) {                     // wholly masked for this warpgroup
      mbar_wait(v_full + st, ph);
      mbar_arrive(empty + st);
      continue;
    }

    // S = Q K^T (64 x 64), fp32
    const uint32_t k_addr = smem_u32(smem + C::kK + st * C::kKVBytes);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk * 16 / C::kPW;
      const uint32_t off = (kk * 16 % C::kPW) * 2;
      const uint64_t da =
          make_desc(q_addr + p * kTcBM * C::kRowBytes + off, 16,
                    8 * C::kRowBytes, C::kLayout);
      const uint64_t db =
          make_desc(k_addr + p * kTcBN * C::kRowBytes + off, 16,
                    8 * C::kRowBytes, C::kLayout);
      wgmma_ss_m64n64(s, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, mask, online softmax (base 2)
    const bool need_mask =
        kv0 + kTcBN - 1 > wq0 || kv0 + kTcBN > Skv ||
        (window > 0 && (wq0 + 63) - kv0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int qp = wq0 + row_a + ((i % 4) >= 2 ? 8 : 0);
        const int kp = kv0 + 8 * (i / 4) + col0 + (i % 2);
        const bool ok = kp <= qp && kp < Skv && (window <= 0 || qp - kp < window);
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[(i % 4) >> 1] = fmaxf(mx[(i % 4) >> 1], x);
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAllLanes, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAllLanes, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) >> 1;
      const float p = exp2f(s[i] - m_use[r]);
      s[i] = p;
      ls[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ls[r];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i % 4) >> 1];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V: P (64 x 64) from registers, V (64 x HD) MN-major
    mbar_wait(v_full + st, ph);
    const uint32_t v_addr = smem_u32(smem + C::kV + st * C::kKVBytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk) {
      const uint64_t db = make_desc(v_addr + kk * 16 * C::kRowBytes,
                                    kTcBN * C::kRowBytes, 8 * C::kRowBytes,
                                    C::kLayout);
      wgmma_rs<HD>(acc, pa + 4 * kk, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + st);
  }

  // out = acc / l, in bf16
  float inv[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(kAllLanes, l, 1);
    l += __shfl_xor_sync(kAllLanes, l, 2);
    lsum[r] = l;
    inv[r] = 1.f / fmaxf(l, 1e-20f);
  }
  if (lse != nullptr && (lane & 3) == 0) {   // training: ln sum exp(s)
    float* lrow = lse + ((long long)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = wq0 + row_a + 8 * r;
      const float m = m_run[r] == -INFINITY ? 0.f : m_run[r];
      if (qp < Sq) {
        lrow[qp] = lsum[r] > 0.f ? (m + log2f(lsum[r])) * 0.69314718055994531f
                                 : -INFINITY;
      }
    }
  }
  o += b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq0 + row_a + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* orow = o + (long long)qp * os.s + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int KV, int Sq, int Skv, int window,
              float scale,
              Strides qs, Strides ks, Strides vs, Strides os,
              cudaStream_t stream) {
  using C = TcCfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HD>(&tq, q, B, H, Sq, qs, kTcBM) ||
      !tensor_map<HD>(&tk, k, B, KV, Skv, ks, kTcBN) ||
      !tensor_map<HD>(&tv, v, B, KV, Skv, vs, kTcBN)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = flash_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTcBM - 1) / kTcBM, H, B);
  const float log2e = 1.4426950408889634f;
  kern<<<grid, kTcThreads, C::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, H, KV, Sq, Skv, window,
      scale * log2e, os);
  return (int)cudaGetLastError();
}

int dispatch_tc(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Skv, int window,
                float scale,
                Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 32: return launch_tc<32>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 64: return launch_tc<64>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 256: return launch_tc<256>(q, k, v, o, lse, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32 (the SIMT kernel), 1 = bf16 (the tensor-core kernel).
// Strides are in elements, for the (B, H, S, hd) view of each tensor; the
// hd axis is contiguous, and for bf16 every pointer is 16-byte aligned and
// every stride a multiple of 8 (TMA's rule). lse, when not null, receives
// the fp32 row log-sum-exp ln sum_j exp(s_ij) (B, H, Sq), contiguous
// (-inf for a row that sees nothing): the backward's input in training.
// Serving passes null.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B,
    int H, int KV, int Sq, int Skv, int hd, int window, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_hd<float>(hd, q, k, v, o, (float*)lse, B, H, KV, Sq, Skv,
                              window, scale, qs, ks, vs, os, s);
  }
  if (dtype == 1) {
    return dispatch_tc(hd, q, k, v, o, (float*)lse, B, H, KV, Sq, Skv, window,
                       scale, qs, ks, vs, os, s);
  }
  return (int)cudaErrorInvalidValue;
}
