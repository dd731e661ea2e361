// Banded max-plus chain recurrence (paper Alg. 3), hand-written for Hopper.
//
// Replaces: src/repro/kernels/chain_scan.py, chain_scan_pallas (kernel body
// _chain_kernel), the TPU kernel of the read mapper's chain stage.
//
//     f(i)   = max(w_i, max_{t in [1,T]} S[i, t-1] + f(i - t))
//     off(i) = argmax_t + 1 if that max is >= w_i, else 0 (a chain start)
//
// with f(i - t) = NEG (-1e18) for i - t < 0 and ties going to the smaller t,
// as jnp.argmax.
//
// What bounds it on this card: the dependency chain. Row i needs f(i-1), so
// the N rows are N serial steps; the bytes (N*T*4 of scores, read once)
// would take microseconds at 3.35 TB/s. The floor is N times the latency of
// one step of the chain.
//
// What the design does about it (Squire's forwarding, on one warp): f(i)
// needs f(i-1) only through its t = 1 term; the other T-1 candidates are
// known 1 ... T-1 rows earlier. So nothing reduces over the band. Row i is
// owned by lane i mod 32, which keeps a running (best, t) pair for it in
// registers from the step it enters the band until it closes. When f(j) is
// final, one __shfl_sync broadcasts it from its owner; every lane adds it
// to the score of each row it owns in (j, j+T] (the plain version's fp32
// add, S[i, i-j-1] + f(j)) and keeps the larger. Candidates of a row arrive
// with t decreasing, so a tie replaces the kept pair: the smallest t wins,
// as jnp.argmax. The owner of row j+1 then has all T candidates, takes the
// max with w, and is the next to broadcast. What stays on the carried
// chain per row: one shuffle, one add and one max (the max of the earlier
// candidates and w is taken before the shuffle). Every step is
// branch-free, so the warp never diverges.
//
// Slots. Rows go in rounds of 32 (round m closes rows 32m .. 32m+31; row
// 32m+s closes at step s, by lane s). A lane holds at most K = ceil(T/32)
// rows in flight: slot d holds row 32(m+d) + lane. Slot 0 closes during the
// round and takes row 32(m+K) + lane, which enters the band at the earliest
// one step later; at the end of the round the slots rotate by one. Rows
// before 0 are virtual: rounds from -ceil((T-1)/32) on close them with f =
// NEG (they weigh NEG and take no candidate), so rows i < T see S[i, t-1] +
// NEG for i - t < 0 in the plain version's order; their results are
// dropped.
//
// Scores. Rows are staged in blocks of 32 in a ring of K+2 blocks in shared
// memory by cp.async, one block ahead: round m reads blocks m .. m+K while
// block m+K+1 lands. At step s, lane l reads row 32(m+d)+l at column
// 32d + l - s (t - 1): with the row stride Ts even, the addresses
// l*(Ts+1) + const fall in 32 distinct banks. f and off of a round are
// written by the whole warp at its end.
//
// blockIdx.x indexes independent problems, one warp each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;
constexpr float kNeg = -1e18f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int ring_slot(int block, int R) {
  const int s = block % R;
  return s < 0 ? s + R : s;
}

// K = ceil(T / 32) rows in flight per lane; the ring holds K + 2 blocks
template <int K>
__global__ void __launch_bounds__(kWarp)
chain_scan_kernel(const float* __restrict__ scores,
                  const float* __restrict__ w, float* __restrict__ f,
                  int32_t* __restrict__ off, int n, int T, int vec) {
  constexpr int R = K + 2;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x;
  const size_t p = blockIdx.x;
  scores += p * (size_t)n * T;
  w += p * (size_t)n;
  f += p * (size_t)n;
  off += p * (size_t)n;
  if (n <= 0) return;

  const int Ts = T + (T & 1);   // even row stride: conflict-free diagonals
  const int blk = kWarp * Ts;   // floats per ring block
  const int nblocks = (n + kWarp - 1) / kWarp;

  // block b (rows 32b .. 32b+31) into ring slot b mod R, as one group
  auto issue = [&](int b) {
    if (b < nblocks) {
      float* dst = ring + ring_slot(b, R) * blk;
      const float* src = scores + (size_t)b * kWarp * T;
      const int rows = min(kWarp, n - b * kWarp);
      if (vec) {   // Ts == T, T % 4 == 0, 16-byte aligned rows
        // (other T copy 4 bytes at a time, several times slower)
        const int count = rows * T / 4;
        for (int e = lane; e < count; e += kWarp) {
          cp_async16(dst + 4 * e, src + 4 * e);
        }
      } else {
        for (int row = 0; row < rows; ++row) {
          for (int c = lane; c < T; c += kWarp) {
            cp_async4(dst + row * Ts + c, src + (size_t)row * T + c);
          }
        }
      }
    }
    cp_async_commit();
  };

  // ring[sent], past the blocks, holds -inf: what a row outside the band
  // reads
  const int sent = R * blk;
  if (lane == 0) ring[sent] = -INFINITY;
  for (int b = 0; b <= K; ++b) issue(b);

  float best[K];                // running max of each slot's candidates
  int bj[K];                    // the j (row of f) that gave it
#pragma unroll
  for (int d = 0; d < K; ++d) {
    best[d] = -INFINITY;
    bj[d] = 0;
  }
  float fc = kNeg;    // f of this lane's row if it closed at the last step
  float fo = 0.f;     // f and off of this lane's row of the round
  int oo = 0;
  const int m0 = -((T - 1 + kWarp - 1) / kWarp);
  auto wload = [&](int row) {   // virtual rows weigh NEG: their f is NEG
    return row < 0 ? kNeg : (row < n ? w[row] : 0.f);
  };
  float wnext = wload(kWarp * m0 + lane);

  for (int m = m0; m < nblocks; ++m) {
    __syncwarp();               // every lane is done with block m - 1
    if (m >= 0) {
      issue(m + K + 1);         // into the slot of block m - 1
    } else {
      cp_async_commit();        // blocks 0 .. K are in flight already
    }
    cp_async_wait<1>();         // blocks up to m + K have landed
    __syncwarp();

    const float wcur = wnext;
    wnext = wload(kWarp * (m + 1) + lane);
    const int row = kWarp * m + lane;

    // slot d: row 32(m+d) + lane, whose t at step s is 32d + lt, lt = lane
    // - s + 1; its score S[row, t-1] sits at ring[cb[d] + lt], and it is in
    // the band while lt <= lim[d] (t <= T). A virtual row never is: it
    // reads ring[sent], keeps best = -inf and closes with f = max(-inf,
    // NEG) = NEG, which the next lane takes as f(j) for j < 0.
    int cb[K], lim[K];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      cb[d] = ring_slot(m + d, R) * blk + lane * Ts + kWarp * d - 1;
      lim[d] = m + d >= 0 ? T - kWarp * d : -(1 << 30);
    }
    // slot 0 once its row has closed: row 32(m+K) + lane (m + K >= 0)
    const int cb_next = ring_slot(m + K, R) * blk + lane * Ts + kWarp * K - 1;

#pragma unroll 16
    for (int s = 0; s < kWarp; ++s) {
      // f(j), j = 32m + s - 1, closed at the last step by lane (s-1) mod 32
      const int j = kWarp * m + s - 1;
      const float fj = __shfl_sync(kFull, fc, (s + kWarp - 1) & 31);
      const int lt = lane - s + 1;
      const float bw = fmaxf(best[0], wcur);   // off the carried chain
      // branch-free: every lane runs every instruction, no divergence
      float c0 = -INFINITY;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const bool in = lt <= lim[d];
        const float c = ring[in ? cb[d] + lt : sent] + fj;
        if (d == 0) c0 = c;
        const bool take = in && c >= best[d];   // a tie replaces: t falls
        best[d] = take ? c : best[d];
        bj[d] = take ? j : bj[d];
      }
      // lane s closes row 32m + s, which has all T terms now; every lane
      // forms fc, only lane s's is taken (at the next step)
      fc = fmaxf(c0, bw);
      const bool close = lt == 1;
      fo = close ? fc : fo;
      oo = close ? (best[0] >= wcur ? row - bj[0] : 0) : oo;
      best[0] = close ? -INFINITY : best[0];
      cb[0] = close ? cb_next : cb[0];
      lim[0] = close ? T - kWarp * K : lim[0];
    }

    if (row >= 0 && row < n) {
      f[row] = fo;
      off[row] = oo;
    }
    // rotate: slot 0 (row 32(m+K) + lane) becomes slot K-1 of round m+1
    const float b0 = best[0];
    const int j0 = bj[0];
#pragma unroll
    for (int d = 0; d + 1 < K; ++d) {
      best[d] = best[d + 1];
      bj[d] = bj[d + 1];
    }
    best[K - 1] = b0;
    bj[K - 1] = j0;
  }
  cp_async_wait<0>();
}

template <int K>
int launch(const void* scores, const void* w, void* f, void* off,
           int problems, int n, int T, cudaStream_t stream) {
  const int Ts = T + (T & 1);
  const size_t smem = sizeof(float) * ((size_t)(K + 2) * kWarp * Ts + 1);
  static bool attr_set = false;
  if (!attr_set) {
    const size_t max_smem =
        sizeof(float) * ((size_t)(K + 2) * kWarp * (kWarp * K) + 1);
    cudaError_t err = cudaFuncSetAttribute(
        chain_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int vec = (T % 4 == 0 && ((uintptr_t)scores & 15) == 0) ? 1 : 0;
  chain_scan_kernel<K><<<problems, kWarp, smem, stream>>>(
      (const float*)scores, (const float*)w, (float*)f, (int32_t*)off, n, T,
      vec);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  switch ((T + kWarp - 1) / kWarp) {
    case 1: return launch<1>(scores, w, f, off, problems, n, T, s);
    case 2: return launch<2>(scores, w, f, off, problems, n, T, s);
    case 3: return launch<3>(scores, w, f, off, problems, n, T, s);
    default: return launch<4>(scores, w, f, off, problems, n, T, s);
  }
}
