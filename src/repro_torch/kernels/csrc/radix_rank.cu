// The LSD radix passes of paper Alg. 1, hand-written for Hopper: the rank
// step (radix_rank), the digit histograms of a whole sort (radix_hist) and
// one rank-and-scatter pass (radix_pass).
//
// Replaces: src/repro/kernels/radix_rank.py, radix_rank_pallas (kernel body
// _rank_kernel), the TPU kernel behind ops.radix_sort_chunks, and the glue
// around it there (exclusive prefix of the histograms, the gather of each
// key's bucket start and the scatter), which radix_hist and radix_pass take
// into two kernels.
//
//   bucket(i) = (key_i >> shift) & 255            (key_i an unsigned 32-bit
//                                                  value, carried as int64)
//   rank(i)   = #{ j < i in the chunk : bucket(j) == bucket(i) }
//   hist[b]   = #{ i in the chunk : bucket(i) == b }
//
// per chunk (one row of keys). The rank is stable: equal buckets keep their
// order, so the scatter start[bucket] + rank is a stable counting-sort pass.
//
// What bounds it on this card: bytes, by the rule of reading each input and
// writing each output once, but in practice latency and order. On the TPU
// the running per-bucket count was a VMEM carry across the sequential grid
// steps over a chunk's key blocks. A CUDA grid runs in no order, so the
// first port gave each chunk one CTA that walked it alone: at 4 chunks 4
// CTAs ran on 132 SMs, and each block of keys cost three barriers and a
// serial walk over 32 warps. What is left after this design is the latency
// of a CTA's dependent steps (ticket, key loads, ranking, look-back, writes)
// times the waves of CTAs, and, in radix_pass, the scatter.
//
// What the design does about it (Merrill and Garland's decoupled look-back,
// as Onesweep uses it for LSD radix sort):
//
// * Each chunk is cut into tiles of 1,024 keys (8 warps, 4 keys a thread)
//   or 2,048 (8 warps, 8 keys a thread), and each tile is one CTA, so a
//   chunk of 16,384 keys is 16 or 8 CTAs. The wrapper takes 2,048 once
//   1,024 would need more than about one wave of resident CTAs. A CTA
//   takes its tile from an atomic ticket and not from blockIdx; tickets
//   map to (chunk, tile) with the tiles of a chunk consecutive, so a tile
//   only ever waits on tiles of its own chunk that are already resident:
//   no deadlock. The ticket is an atomicInc that wraps to 0 at the grid's
//   last CTA, so it is 0 again for the next launch.
// * Inside a tile, warp w ranks keys tile + w * 32 kKpt + k * 32 + lane in
//   k order: __match_any_sync groups the lanes of one bucket, a lane's rank
//   is the warp's running count of the bucket plus __popc(peers & lanes
//   below), and the group's lowest lane adds the group's size to the count
//   in a (bucket, warp) table in shared memory. Each bucket's column of
//   warp counts then becomes its exclusive prefix by a shuffle scan of
//   kWarps lanes (log2 kWarps steps; 8 rounds of 32 buckets cover the 256).
// * Across tiles: per (tile, bucket) one 64-bit status word, epoch (30
//   bits) | flag (2 bits: aggregate or inclusive prefix) | count (32 bits,
//   so any chunk_len below 2^31). Thread b publishes the tile's count of
//   bucket b as an aggregate (tile 0: as its inclusive prefix), then looks
//   back over the chunk's earlier tiles, kWindow words a load round: it
//   adds each aggregate and stops at the first inclusive prefix; a word of
//   another epoch is not yet published and is read again. It then
//   publishes its own inclusive prefix. Flag and count share one word, so a
//   flag is never seen without its count, and the accesses are relaxed
//   (see store_word). The wrapper gives every launch a new epoch, so words
//   left by an earlier launch are stale and need no clearing.
// * radix_hist reads the keys once and counts every pass's digit (shared
//   atomics, then one global atomic per (pass, bucket) and tile). The last
//   tile of each chunk (an atomicInc per chunk that wraps to 0) takes the
//   sums with atomicExch(0), which leaves the accumulators clear for the
//   next launch, and writes each histogram and its exclusive prefix, the
//   bucket starts.
// * radix_pass ranks as radix_rank, stages the tile's keys and values in
//   shared memory in bucket order, and then writes them out in that order,
//   each to start[bucket] + earlier tiles' count + place within the tile's
//   run of the bucket: neighbouring threads write neighbouring places, not
//   one bucket each. With no values given it writes each key's index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kHistKpt = 4;    // keys a thread counts in radix_hist
constexpr int kWindow = 4;     // status words a look-back round loads
constexpr int kMaxPasses = 4;  // 8-bit digits of a 32-bit key

constexpr uint64_t kAggregate = 1ull << 32;
constexpr uint64_t kInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
constexpr uint64_t kEpochMask = ~((1ull << kEpochShift) - 1ull);

// Flag and count share one 64-bit word, which a relaxed access at gpu scope
// moves whole (single-copy atomic): a reader sees the old word or the new
// one. No other data rides on the flag, so release and acquire would order
// nothing the reader uses (they cost 2-3 us a launch on an H100:
// tools/radix_design.py).
__device__ __forceinline__ void store_word(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

struct TileArgs {
  const int64_t* keys;     // (n_chunks, chunk_len)
  int32_t* ranks;          // rank: (n_chunks, chunk_len)
  int32_t* hists;          // rank: (n_chunks, 256)
  const int32_t* starts;   // pass: (n_chunks, n_passes, 256) bucket starts
  const void* vals;        // pass: (n_chunks, chunk_len), or null
  int64_t* keys_out;       // pass
  void* vals_out;          // pass
  uint64_t* status;        // (n_tiles, 256) epoch-tagged status words
  unsigned* ticket;        // 0 between launches
  long long chunk_len;
  int tiles_per_chunk;
  unsigned n_tiles;
  int shift;
  int pass;
  int n_passes;
  uint64_t epoch;          // this launch's epoch << kEpochShift
};

// exclusive prefix of v over threads 0..255 (the others pass 0); every
// thread of the block calls it
__device__ __forceinline__ int exclusive_256(int v, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31 && warp < kRadix / 32) wsum[warp] = incl;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp && w < kRadix / 32; ++w) off += wsum[w];
  __syncthreads();
  return off + incl - v;
}

template <int kVal> struct Staged { using type = uint32_t; };
template <> struct Staged<0> { using type = uint8_t; };   // rank: unused
template <> struct Staged<8> { using type = uint64_t; };

// Ranks one tile of kWarps * 32 * kKpt keys. kVal: 0 for radix_rank (ranks
// and histograms out); for radix_pass the bytes of a value, 4 or 8, or -1
// to write each key's index as the value.
template <int kWarps, int kKpt, int kVal>
__global__ void __launch_bounds__(kWarps * 32)
rank_tiles_kernel(TileArgs a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTile = kThreads * kKpt;
  constexpr int kPitch = kWarps + 1;        // odd: conflict-free columns
  constexpr bool kScatter = kVal != 0;
  constexpr int kStage = kScatter ? kTile : 1;
  using Val = typename Staged<kVal>::type;
  static_assert(kThreads >= kRadix, "one look-back thread per bucket");
  __shared__ int32_t cnt[kRadix * kPitch];  // (bucket, warp) counts
  __shared__ int32_t agg[kRadix];           // the tile's count per bucket
  __shared__ int32_t before[kRadix];        // earlier tiles' count
  __shared__ int32_t start[kRadix];         // pass: bucket starts
  __shared__ int32_t in_tile[kRadix];       // pass: bucket's first place
  __shared__ int wsum[kRadix / 32];
  __shared__ int64_t skey[kStage];          // pass: the tile in bucket order
  __shared__ Val sval[kStage];
  __shared__ unsigned tile_id;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lt_mask = (1u << lane) - 1u;

  if (tid == 0) tile_id = atomicInc(a.ticket, a.n_tiles - 1u);
  for (int i = tid; i < kRadix * kPitch; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const unsigned t = tile_id;
  const int chunk = (int)(t / (unsigned)a.tiles_per_chunk);
  const int tile = (int)(t % (unsigned)a.tiles_per_chunk);
  const size_t row = (size_t)chunk * (size_t)a.chunk_len;
  const long long tile0 = (long long)tile * kTile;
  const long long first = tile0 + warp * (32 * kKpt) + lane;
  if (kScatter && tid < kRadix) {
    start[tid] =
        a.starts[((size_t)chunk * a.n_passes + a.pass) * kRadix + tid];
  }

  int64_t key[kKpt];
  int digit[kKpt];
  int rank[kKpt];
#pragma unroll
  for (int k = 0; k < kKpt; ++k) {
    const long long idx = first + k * 32;
    key[k] = idx < a.chunk_len ? a.keys[row + idx] : 0;
    digit[k] = (int)(((uint32_t)key[k] >> a.shift) & (kRadix - 1));
  }

  // rank within the warp, in key order: k, then lane
#pragma unroll
  for (int k = 0; k < kKpt; ++k) {
    const bool valid = first + k * 32 < a.chunk_len;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    if (active == 0) break;                 // warp-uniform: later k too
    int* slot = &cnt[digit[k] * kPitch + warp];
    unsigned peers = 0;
    int pre = 0;
    if (valid) {
      peers = __match_any_sync(active, digit[k]);
      pre = *slot;
    }
    __syncwarp();
    if (valid && (peers & lt_mask) == 0) *slot = pre + __popc(peers);
    __syncwarp();
    rank[k] = pre + __popc(peers & lt_mask);
  }
  __syncthreads();

  // each bucket's column over the warps -> exclusive prefix, by a shuffle
  // scan of kWarps lanes; lane = sub * kWarps + w holds (bucket, warp w)
  {
    const int w = lane % kWarps;
    const int sub = lane / kWarps;
#pragma unroll
    for (int r = 0; r < kRadix / 32; ++r) {
      const int b = r * 32 + warp * (32 / kWarps) + sub;
      const int v = cnt[b * kPitch + w];
      int incl = v;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o, kWarps);
        if (w >= o) incl += up;
      }
      cnt[b * kPitch + w] = incl - v;
      if (w == kWarps - 1) agg[b] = incl;
    }
  }
  __syncthreads();

  // publish, look back, publish the inclusive prefix
  if (tid < kRadix) {
    uint64_t* word = a.status + (size_t)t * kRadix + tid;
    const uint32_t mine = (uint32_t)agg[tid];
    uint32_t sum = 0;
    if (tile == 0) {
      store_word(word, a.epoch | kInclusive | mine);
    } else {
      store_word(word, a.epoch | kAggregate | mine);
      int j = 1;                            // looking at tile - j
      bool found = false;
      while (!found) {
        uint64_t w[kWindow];
#pragma unroll
        for (int k = 0; k < kWindow; ++k) {
          w[k] = j + k <= tile ? load_word(word - (size_t)(j + k) * kRadix)
                               : 0;
        }
        int k = 0;
        for (; k < kWindow && j + k <= tile; ++k) {
          if ((w[k] & kEpochMask) != a.epoch) break;   // not yet published
          sum += (uint32_t)w[k];
          if (w[k] & kInclusive) {
            found = true;
            break;
          }
        }
        j += k;
      }
      store_word(word, a.epoch | kInclusive | (sum + mine));
    }
    before[tid] = (int)sum;
    if (!kScatter && tile == a.tiles_per_chunk - 1) {
      a.hists[(size_t)chunk * kRadix + tid] = (int32_t)(sum + mine);
    }
  }

  if constexpr (!kScatter) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKpt; ++k) {
      const long long idx = first + k * 32;
      if (idx >= a.chunk_len) break;
      const int d = digit[k];
      a.ranks[row + idx] = before[d] + cnt[d * kPitch + warp] + rank[k];
    }
  } else {
    // stage the tile in bucket order, so that neighbouring threads write
    // neighbouring places of a bucket's run
    const int ex = exclusive_256(tid < kRadix ? agg[tid] : 0, wsum);
    if (tid < kRadix) in_tile[tid] = ex;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKpt; ++k) {
      const long long idx = first + k * 32;
      if (idx >= a.chunk_len) break;
      const int d = digit[k];
      const int place = in_tile[d] + cnt[d * kPitch + warp] + rank[k];
      skey[place] = key[k];
      if constexpr (kVal == -1) {
        sval[place] = (uint32_t)idx;
      } else {
        sval[place] = ((const Val*)a.vals)[row + idx];
      }
    }
    __syncthreads();
    const int n = (int)min((long long)kTile, a.chunk_len - tile0);
    for (int i = tid; i < n; i += kThreads) {
      const int64_t kv = skey[i];
      const int d = (int)(((uint32_t)kv >> a.shift) & (kRadix - 1));
      const size_t pos =
          row + (size_t)(start[d] + before[d] + i - in_tile[d]);
      a.keys_out[pos] = kv;
      ((Val*)a.vals_out)[pos] = sval[i];
    }
  }
}

// Every pass's digit histogram of every chunk, and its exclusive prefix.
// acc (n_chunks, kMaxPasses, 256) and done (n_chunks) are 0 on entry and
// are left 0.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
radix_hist_kernel(const int64_t* __restrict__ keys, int32_t* hists,
                  int32_t* starts, unsigned* acc, unsigned* done,
                  long long chunk_len, int tiles_per_chunk, int n_passes) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTile = kThreads * kHistKpt;
  __shared__ unsigned sh[kMaxPasses * kRadix];
  __shared__ int wsum[kRadix / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = blockIdx.x / tiles_per_chunk;
  const int tile = blockIdx.x % tiles_per_chunk;
  const size_t row = (size_t)chunk * (size_t)chunk_len;
  const long long first =
      (long long)tile * kTile + warp * (32 * kHistKpt) + lane;

  for (int i = tid; i < kMaxPasses * kRadix; i += kThreads) sh[i] = 0;
  __syncthreads();
  uint32_t key[kHistKpt];
#pragma unroll
  for (int k = 0; k < kHistKpt; ++k) {
    const long long idx = first + k * 32;
    key[k] = idx < chunk_len ? (uint32_t)keys[row + idx] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kHistKpt; ++k) {
    if (first + k * 32 >= chunk_len) break;
    for (int p = 0; p < n_passes; ++p) {
      atomicAdd(&sh[p * kRadix + ((key[k] >> (8 * p)) & (kRadix - 1))], 1u);
    }
  }
  __syncthreads();
  unsigned* mine = acc + (size_t)chunk * kMaxPasses * kRadix;
  for (int i = tid; i < n_passes * kRadix; i += kThreads) {
    if (sh[i]) atomicAdd(&mine[i], sh[i]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicInc(&done[chunk], (unsigned)tiles_per_chunk - 1u) ==
           (unsigned)tiles_per_chunk - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < n_passes; ++p) {
    const int v = tid < kRadix ? (int)atomicExch(&mine[p * kRadix + tid], 0u)
                               : 0;
    const int ex = exclusive_256(v, wsum);
    if (tid < kRadix) {
      const size_t o = ((size_t)chunk * n_passes + p) * kRadix + tid;
      hists[o] = v;
      starts[o] = ex;
    }
  }
}

template <int kVal>
cudaError_t launch_tiles(int tile, unsigned n_tiles, const TileArgs& a,
                         cudaStream_t stream) {
  if (tile == 1024) {
    rank_tiles_kernel<8, 4, kVal><<<n_tiles, 256, 0, stream>>>(a);
  } else {
    rank_tiles_kernel<8, 8, kVal><<<n_tiles, 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// 0 if the shape is taken, with the tile count per chunk and in all
int tiles_of(int n_chunks, long long chunk_len, int tile, int* per_chunk,
             unsigned* n_tiles) {
  if (n_chunks < 1 || chunk_len < 1 || chunk_len >= (1ll << 31) ||
      (tile != 1024 && tile != 2048)) {
    return 1;
  }
  const long long per = (chunk_len + tile - 1) / tile;
  const long long all = per * n_chunks;
  if (all >= (1ll << 31)) return 1;
  *per_chunk = (int)per;
  *n_tiles = (unsigned)all;
  return 0;
}

bool epochs_ok(unsigned epoch, int count) {
  return epoch >= 1 && (unsigned long long)epoch + count <= (1ull << 30);
}

// one pass: val_bytes 0 writes each key's index as the value
cudaError_t launch_pass(const TileArgs& a, int val_bytes, int tile,
                        cudaStream_t s) {
  if (val_bytes == 0) return launch_tiles<-1>(tile, a.n_tiles, a, s);
  if (val_bytes == 4) return launch_tiles<4>(tile, a.n_tiles, a, s);
  return launch_tiles<8>(tile, a.n_tiles, a, s);
}

cudaError_t launch_hist(const void* keys, void* hists, void* starts,
                        void* acc, void* done, long long chunk_len,
                        int per_chunk, unsigned n_tiles, int n_passes,
                        int tile, cudaStream_t s) {
  if (tile == 1024) {
    radix_hist_kernel<8><<<n_tiles, 256, 0, s>>>(
        (const int64_t*)keys, (int32_t*)hists, (int32_t*)starts,
        (unsigned*)acc, (unsigned*)done, chunk_len, per_chunk, n_passes);
  } else {
    radix_hist_kernel<16><<<n_tiles, 512, 0, s>>>(
        (const int64_t*)keys, (int32_t*)hists, (int32_t*)starts,
        (unsigned*)acc, (unsigned*)done, chunk_len, per_chunk, n_passes);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int radix_rank_launch(const void* keys, void* ranks, void* hists,
                                 void* status, void* ticket, int n_chunks,
                                 long long chunk_len, int shift, int tile,
                                 unsigned epoch, int device, void* stream) {
  TileArgs a = {};
  if (tiles_of(n_chunks, chunk_len, tile, &a.tiles_per_chunk, &a.n_tiles) ||
      shift < 0 || shift > 31 || !epochs_ok(epoch, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  a.keys = (const int64_t*)keys;
  a.ranks = (int32_t*)ranks;
  a.hists = (int32_t*)hists;
  a.status = (uint64_t*)status;
  a.ticket = (unsigned*)ticket;
  a.chunk_len = chunk_len;
  a.shift = shift;
  a.epoch = (uint64_t)epoch << kEpochShift;
  return (int)launch_tiles<0>(tile, a.n_tiles, a, (cudaStream_t)stream);
}

extern "C" int radix_pass_launch(const void* keys, const void* vals,
                                 void* keys_out, void* vals_out,
                                 const void* starts, void* status,
                                 void* ticket, int n_chunks,
                                 long long chunk_len, int pass, int n_passes,
                                 int val_bytes, int tile, unsigned epoch,
                                 int device, void* stream) {
  TileArgs a = {};
  if (tiles_of(n_chunks, chunk_len, tile, &a.tiles_per_chunk, &a.n_tiles) ||
      n_passes < 1 || n_passes > kMaxPasses || pass < 0 ||
      pass >= n_passes || !epochs_ok(epoch, 1) ||
      (vals == nullptr) != (val_bytes == 0) ||
      (val_bytes != 0 && val_bytes != 4 && val_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  a.keys = (const int64_t*)keys;
  a.starts = (const int32_t*)starts;
  a.vals = vals;
  a.keys_out = (int64_t*)keys_out;
  a.vals_out = vals_out;
  a.status = (uint64_t*)status;
  a.ticket = (unsigned*)ticket;
  a.chunk_len = chunk_len;
  a.shift = 8 * pass;
  a.pass = pass;
  a.n_passes = n_passes;
  a.epoch = (uint64_t)epoch << kEpochShift;
  return (int)launch_pass(a, val_bytes, tile, (cudaStream_t)stream);
}

extern "C" int radix_hist_launch(const void* keys, void* hists, void* starts,
                                 void* acc, void* done, int n_chunks,
                                 long long chunk_len, int n_passes, int tile,
                                 int device, void* stream) {
  int per_chunk;
  unsigned n_tiles;
  if (tiles_of(n_chunks, chunk_len, tile, &per_chunk, &n_tiles) ||
      n_passes < 1 || n_passes > kMaxPasses) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_hist(keys, hists, starts, acc, done, chunk_len,
                          per_chunk, n_tiles, n_passes, tile,
                          (cudaStream_t)stream);
}

// The whole sort from one call: radix_hist, then one radix_pass per digit,
// pass p reading keys (p = 0) or buffer (p - 1) % 2 and writing buffer
// p % 2 of keys_buf and vals_buf (each 2 x n_chunks x chunk_len, or 1 x
// when there is one pass). Pass p takes epoch + p. With vals null the
// first pass writes each key's index, and later passes carry it as int32.
// Each launch's error is checked before the next.
extern "C" int radix_sort_launch(const void* keys, const void* vals,
                                 void* keys_buf, void* vals_buf, void* hists,
                                 void* starts, void* acc, void* done,
                                 void* status, void* ticket, int n_chunks,
                                 long long chunk_len, int n_passes,
                                 int val_bytes, int tile, unsigned epoch,
                                 int device, void* stream) {
  TileArgs a = {};
  if (tiles_of(n_chunks, chunk_len, tile, &a.tiles_per_chunk, &a.n_tiles) ||
      n_passes < 1 || n_passes > kMaxPasses ||
      !epochs_ok(epoch, n_passes) || (vals == nullptr) != (val_bytes == 0) ||
      (val_bytes != 0 && val_bytes != 4 && val_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = launch_hist(keys, hists, starts, acc, done, chunk_len,
                    a.tiles_per_chunk, a.n_tiles, n_passes, tile, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)n_chunks * (size_t)chunk_len;
  const int carried = val_bytes == 0 ? 4 : val_bytes;   // after pass 0
  a.starts = (const int32_t*)starts;
  a.status = (uint64_t*)status;
  a.ticket = (unsigned*)ticket;
  a.chunk_len = chunk_len;
  a.n_passes = n_passes;
  for (int p = 0; p < n_passes; ++p) {
    a.keys = p == 0 ? (const int64_t*)keys
                    : (const int64_t*)keys_buf + ((p - 1) % 2) * n;
    a.keys_out = (int64_t*)keys_buf + (p % 2) * n;
    a.vals = p == 0 ? vals
                    : (const char*)vals_buf + ((p - 1) % 2) * n * carried;
    a.vals_out = (char*)vals_buf + (p % 2) * n * carried;
    a.shift = 8 * p;
    a.pass = p;
    a.epoch = (uint64_t)(epoch + p) << kEpochShift;
    err = launch_pass(a, p == 0 ? val_bytes : carried, tile, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
