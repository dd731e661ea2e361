// WKV recurrence (RWKV6 time mix), hand-written for Hopper.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_pallas (kernel body
// _ssm_kernel), the TPU kernel of the RWKV6 WKV scan.
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state S: dk x dv)
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// One row b of the (B, T, d) inputs is one (batch, head) pair. Beyond the
// TPU kernel, the state starts at s0 (B, dk, dv) when one is given, else at
// zero, and the final state is written to s_final (B, dk, dv).
//
// What bounds it on this card: the dependency chain along T. Bytes are
// B*T*(3*dk + 2*dv)*4 (about 0.1 ms at the prefill shape B=128, T=2048,
// dk=dv=64) and operations about 5*B*T*dk*dv (about 0.08 ms at fp32 peak);
// but each row's T steps are serial, and each step is dk dependent
// multiply-adds per value column, so the time is T times the latency of
// one step.
//
// What the design does about it: the TPU carried the state in VMEM scratch
// across the ordered chunk axis of its grid; a CUDA grid has no order, so
// the chunk axis becomes a loop inside one CTA per row, and the parallelism
// is the B rows (128 CTAs at the prefill shape). Thread j owns the state
// column S[:, j] in registers (kDK floats, indices known at compile time;
// rows at and past dk stay zero because their staged r, w and k are zero).
// Per chunk of kC steps, r, w, k and v are staged in shared memory with
// coalesced loads; every thread then reads the same r, w, k, u quad as a
// broadcast float4. The readout is split over four partial sums to shorten
// the chain of dependent adds, and y[t, :] is written coalesced across the
// CTA. The inputs are fp32, as the TPU kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 64;       // dk <= kDK
constexpr int kDVMax = 128;   // dv <= kDVMax: one thread per value column
constexpr int kC = 32;        // time steps staged in shared memory at once

__device__ __forceinline__ void wkv_step(float r, float w, float k, float u,
                                         float vj, float& s, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);   // readout uses S_{t-1}
  s = fmaf(w, s, kv);
}

__global__ void __launch_bounds__(kDVMax)
ssm_scan_kernel(const float* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_final,
                int T, int dk, int dv) {
  __shared__ __align__(16) float sr[kC][kDK];
  __shared__ __align__(16) float sw[kC][kDK];
  __shared__ __align__(16) float sk[kC][kDK];
  __shared__ __align__(16) float su[kDK];
  __shared__ float sv[kC][kDVMax];

  const int j = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool live = j < dv;
  const size_t row = blockIdx.x;
  r += row * (size_t)T * dk;
  w += row * (size_t)T * dk;
  k += row * (size_t)T * dk;
  v += row * (size_t)T * dv;
  y += row * (size_t)T * dv;

  for (int i = j; i < kDK; i += nthreads) {
    su[i] = (u != nullptr && i < dk) ? u[i] : 0.f;
  }

  float s[kDK];
#pragma unroll
  for (int i = 0; i < kDK; ++i) {
    s[i] = 0.f;
    if (s0 != nullptr && live && i < dk) {
      s[i] = s0[(row * dk + i) * dv + j];
    }
  }

  for (int t0 = 0; t0 < T; t0 += kC) {
    const int n = min(kC, T - t0);
    __syncthreads();   // every reader of the previous chunk is done
    for (int e = j; e < kC * kDK; e += nthreads) {
      const int tt = e / kDK;
      const int i = e - tt * kDK;
      const bool in = tt < n && i < dk;
      const size_t g = (size_t)(t0 + tt) * dk + i;
      sr[tt][i] = in ? r[g] : 0.f;
      sw[tt][i] = in ? w[g] : 0.f;
      sk[tt][i] = in ? k[g] : 0.f;
    }
    for (int e = j; e < kC * dv; e += nthreads) {
      const int tt = e / dv;
      const int c = e - tt * dv;
      sv[tt][c] = tt < n ? v[(size_t)(t0 + tt) * dv + c] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < n; ++tt) {
        const float vj = sv[tt][j];
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
        for (int i = 0; i < kDK; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
          const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
          wkv_step(r4.x, w4.x, k4.x, u4.x, vj, s[i], acc0);
          wkv_step(r4.y, w4.y, k4.y, u4.y, vj, s[i + 1], acc1);
          wkv_step(r4.z, w4.z, k4.z, u4.z, vj, s[i + 2], acc2);
          wkv_step(r4.w, w4.w, k4.w, u4.w, vj, s[i + 3], acc3);
        }
        y[(size_t)(t0 + tt) * dv + j] = (acc0 + acc1) + (acc2 + acc3);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kDK; ++i) {
    if (live && i < dk) s_final[(row * dk + i) * dv + j] = s[i];
  }
}

}  // namespace

extern "C" int ssm_scan_launch(const void* r, const void* w, const void* k,
                               const void* v, const void* u, const void* s0,
                               void* y, void* s_final, int B, int T, int dk,
                               int dv, int device, void* stream) {
  if (B < 1 || T < 0 || dk < 1 || dk > kDK || dv < 1 || dv > kDVMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = (dv + 31) / 32 * 32;
  ssm_scan_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)w, (const float*)k, (const float*)v,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_final, T, dk,
      dv);
  return (int)cudaGetLastError();
}
