// One 8-bit LSD radix pass's rank step (paper Alg. 1), hand-written for
// Hopper.
//
// Replaces: src/repro/kernels/radix_rank.py, radix_rank_pallas (kernel body
// _rank_kernel), the TPU kernel behind ops.radix_sort_chunks.
//
//   bucket(i) = (key_i >> shift) & 255            (key_i an unsigned 32-bit
//                                                  value, carried as int64)
//   rank(i)   = #{ j < i in the chunk : bucket(j) == bucket(i) }
//   hist[b]   = #{ i in the chunk : bucket(i) == b }
//
// per chunk (one row of keys). The rank is stable: equal buckets keep their
// order, which is what makes the scatter start[bucket] + rank a stable
// counting-sort pass.
//
// What bounds it on this card: bytes, by the rule of reading each input and
// writing each output once (8 bytes of key in, 4 bytes of rank out per key),
// but in practice the ordering. On the TPU the running per-bucket count was
// a VMEM carry across the sequential grid steps over a chunk's key blocks; a
// CUDA grid runs blocks in no order, so the carry stays inside one CTA and a
// chunk is a loop of dependent block steps, each ended by block barriers.
//
// What the design does about it: one CTA of kThreads threads per chunk,
// looping over the chunk's keys in blocks of kThreads, one key per thread.
// Within a warp, __match_any_sync groups the lanes that share a bucket and
// __popc(peers & lanemask_lt) is a lane's rank among the earlier lanes of
// its group; the group's lowest lane writes the group's size into the
// warp's row of a (warps x 256) count table in shared memory. After a
// barrier, thread b walks bucket b's column in warp order, replacing each
// count by the exclusive prefix over the earlier warps plus the running
// count of all earlier blocks, and adds the block's total to the running
// count. After another barrier each key's rank is its warp's base plus its
// rank within the warp. So warp w's keys rank after warps 0..w-1 of the
// same block, which rank after every earlier block. A ragged last block
// masks its idle lanes out of the match (the mask is the ballot of the
// lanes that hold a key). The 256 running counts are the histogram.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
radix_rank_kernel(const int64_t* __restrict__ keys, int32_t* __restrict__ ranks,
                  int32_t* __restrict__ hists, int chunk_len, int shift) {
  __shared__ int32_t wcnt[kWarps * kRadix];   // (warp, bucket) counts
  __shared__ int32_t running[kRadix];         // counts of earlier blocks
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const size_t row = (size_t)blockIdx.x * (size_t)chunk_len;
  keys += row;
  ranks += row;

  for (int b = tid; b < kRadix; b += kThreads) running[b] = 0;

  for (int base = 0; base < chunk_len; base += kThreads) {
    for (int i = tid; i < kWarps * kRadix; i += kThreads) wcnt[i] = 0;
    __syncthreads();

    const int idx = base + tid;
    const bool valid = idx < chunk_len;
    const int bucket =
        valid ? (int)(((uint32_t)keys[idx] >> shift) & (kRadix - 1)) : 0;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    int in_warp = 0;
    if (valid) {
      const unsigned peers = __match_any_sync(active, bucket);
      in_warp = __popc(peers & lt_mask);
      if (in_warp == 0) wcnt[warp * kRadix + bucket] = __popc(peers);
    }
    __syncthreads();

    for (int b = tid; b < kRadix; b += kThreads) {
      int run = running[b];
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcnt[w * kRadix + b];
        wcnt[w * kRadix + b] = run;
        run += c;
      }
      running[b] = run;
    }
    __syncthreads();

    if (valid) ranks[idx] = wcnt[warp * kRadix + bucket] + in_warp;
    __syncthreads();   // the next block clears wcnt
  }

  int32_t* hist = hists + (size_t)blockIdx.x * kRadix;
  for (int b = tid; b < kRadix; b += kThreads) hist[b] = running[b];
}

}  // namespace

extern "C" int radix_rank_launch(const void* keys, void* ranks, void* hists,
                                 int n_chunks, int chunk_len, int shift,
                                 int device, void* stream) {
  if (n_chunks < 1 || chunk_len < 1 || shift < 0 || shift > 31) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  radix_rank_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (int32_t*)ranks, (int32_t*)hists, chunk_len,
      shift);
  return (int)cudaGetLastError();
}
