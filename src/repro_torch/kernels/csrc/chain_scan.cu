// Banded max-plus chain recurrence (paper Alg. 3), hand-written for Hopper.
//
// Replaces: src/repro/kernels/chain_scan.py, chain_scan_pallas (kernel body
// _chain_kernel), the TPU kernel of the read mapper's chain stage.
//
//     f(i)   = max(w_i, max_{t in [1,T]} S[i, t-1] + f(i - t))
//     off(i) = argmax_t + 1 if that max >= w_i, else 0 (a chain start)
//
// What bounds it on this card: the dependency chain. Row i needs f(i-1), so
// the N rows are N serial steps, each a warp-wide max-reduce of latency
// ~100-200 cycles; the bytes (N*T*4 of scores, read once) would take
// microseconds at 3.35 TB/s, the serial steps take far longer.
//
// What the design does about it: on the TPU the ring of the last T values of
// f crossed sequential grid steps; a CUDA grid runs its blocks in no order,
// so the whole recurrence stays inside one warp. blockIdx.x indexes
// independent problems (the read mapper launches one). Lane l owns band
// slots l, l+32, l+64, l+96 (T <= 128). The ring is a circular buffer in
// shared memory with a head index (no shifting). Each step loads its score
// row coalesced while the next row is already prefetched into registers,
// forms cand = S + ring with one fp32 add per slot, and reduces with warp
// shuffles, ties going to the smaller t like jnp.argmax. Lane 0 writes f,
// off and the ring entry; __syncwarp orders the ring write before the next
// step's reads. The fp32 adds and the max are the plain version's, so f
// and off match it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;
constexpr int kSlots = kMaxT / kWarp;
constexpr float kNeg = -1e18f;

__global__ void __launch_bounds__(kWarp)
chain_scan_kernel(const float* __restrict__ scores,
                  const float* __restrict__ w,
                  float* __restrict__ f,
                  int32_t* __restrict__ off,
                  int n, int T) {
  __shared__ float ring[kMaxT];
  const int lane = threadIdx.x;
  const size_t p = blockIdx.x;
  scores += p * (size_t)n * T;
  w += p * (size_t)n;
  f += p * (size_t)n;
  off += p * (size_t)n;

  for (int s = lane; s < T; s += kWarp) ring[s] = kNeg;
  __syncwarp();
  if (n <= 0) return;

  // ring[head] = f(i-1); f(i-t) sits at ring[(head - (t-1)) mod T]
  int head = T - 1;
  float cur[kSlots], nxt[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int s = lane + m * kWarp;
    cur[m] = s < T ? scores[s] : 0.f;
    nxt[m] = 0.f;
  }
  float wcur = w[0];

  for (int i = 0; i < n; ++i) {
    const bool more = i + 1 < n;
    const float* next_row = scores + (size_t)(i + 1) * T;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int s = lane + m * kWarp;
      if (more && s < T) nxt[m] = next_row[s];
    }
    const float wnext = more ? w[i + 1] : 0.f;

    float best = -INFINITY;
    int bt = 0x7fffffff;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int s = lane + m * kWarp;
      if (s < T) {
        int slot = head - s;
        if (slot < 0) slot += T;
        const float c = cur[m] + ring[slot];
        if (c > best) {
          best = c;
          bt = s;
        }
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, o);
      if (ov > best || (ov == best && ot < bt)) {
        best = ov;
        bt = ot;
      }
    }

    head = head + 1 == T ? 0 : head + 1;
    if (lane == 0) {
      const bool extend = best >= wcur;
      const float fi = extend ? best : wcur;
      f[i] = fi;
      off[i] = extend ? bt + 1 : 0;
      ring[head] = fi;   // overwrites f(i-T), which no later row reads
    }
    __syncwarp();

#pragma unroll
    for (int m = 0; m < kSlots; ++m) cur[m] = nxt[m];
    wcur = wnext;
  }
}

}  // namespace

extern "C" int chain_scan_launch(const void* scores, const void* w, void* f,
                                 void* off, int problems, int n, int T,
                                 int device, void* stream) {
  if (T < 1 || T > kMaxT || n < 0 || problems < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  chain_scan_kernel<<<problems, kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)w, (float*)f, (int32_t*)off, n, T);
  return (int)cudaGetLastError();
}
