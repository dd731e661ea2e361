// Fused causal attention with GQA/MQA and an optional sliding window,
// hand-written for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (kernel body _flash_kernel), the TPU kernel of the model's attention.
//
//     out[b, h, i] = sum_j p_ij v[b, h / (H / KV), j] / max(sum_j p_ij, 1e-20)
//     p_ij = exp(s_ij - m_i) where j <= i (and i - j < window when
//            window > 0), else 0;  s_ij = (q_i * hd^-0.5) . k_j
//
// Positions count from 0 in q and in kv alike, as in the TPU kernel. The
// inputs are fp32 or bf16 and are upcast to fp32; m, l and the output
// accumulator are fp32, and the output is written in the input type. Masked
// scores are -1e30 and their p is 0, so rows with nothing visible give 0.
// Unlike the TPU kernel, any Sq and Skv are taken: the ragged edges are
// masked here, not padded by the caller.
//
// What bounds it on this card: operations. At gemma-2b's prefill shape
// (B=4, H=8, KV=1, S=2048, hd=256) the causal half of the products is about
// 69 GFLOP against 75 MB of q, k, v and out: about 0.07 ms at the bf16
// tensor-core peak, about 1 ms at the fp32 peak outside the tensor cores,
// 0.02 ms of bytes. This first version does its products on the fp32 cores,
// so the fp32 peak is its roof; tensor cores (mma / wgmma) and TMA are later
// work.
//
// Design. One CTA owns one (batch, head, 64-row q block) and loops over the
// 64-row kv tiles from the window's first tile to the causal edge, so the
// online-softmax carry (m, l, acc) never leaves the CTA; tiles that are
// wholly masked are skipped, which changes no bit (m is unchanged there, the
// correction is exp(0) = 1 and p is 0). The q blocks run from the last to
// the first, so the longest CTAs start first. The q block, one k tile and
// one v tile sit in shared memory as fp32 (about 210 KB at hd 256); the
// query head reads its kv head through the index h / (H / KV), so grouped
// heads share k and v without a broadcast copy. Each of the 8 warps owns 8
// q rows: for the scores, lane l holds kv columns l and l + 32 of its 8 rows
// (q read as broadcast float4s, k rows padded by 4 floats so the float4
// reads meet no bank conflict); the row max and sum are warp shuffles; p
// goes through shared memory to the p.v product, where lane l owns the
// output columns l, l + 32, ... of its 8 rows. Inputs may be strided views
// (the model's (B, S, H, hd) layout seen as (B, H, S, hd)); the last axis
// must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // q rows per CTA
constexpr int kBK = 64;                // kv rows per tile
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;    // q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

struct Strides {
  long long b, h, s;
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
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Skv, int window, float scale,
                       Strides qs, Strides ks, Strides vs, Strides os) {
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
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Skv, int window, float scale, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<HD>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, Layout<HD>::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Skv, window,
      scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int H, int KV, int Sq, int Skv, int window, float scale,
                Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Skv, window, scale, qs, ks, vs, os, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Strides are in elements, for the (B, H, S, hd)
// view of each tensor; the hd axis is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
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
    return dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, window, scale,
                              qs, ks, vs, os, s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Skv,
                                      window, scale, qs, ks, vs, os, s);
  }
  return (int)cudaErrorInvalidValue;
}
