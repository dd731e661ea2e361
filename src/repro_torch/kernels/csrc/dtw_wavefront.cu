// One 2-D DP wavefront tile (Smith-Waterman or DTW), hand-written for Hopper.
//
// Replaces: src/repro/kernels/dtw_wavefront.py, dp_tile_pallas (kernel body
// _dp_tile_kernel), the TPU kernel of the read mapper's align stage
// (kind "sw") and of the tiled DTW (kind "dtw").
//
//   sw : M[i,j] = max(0, diag + (a_i == b_j ? match : mismatch),
//                     up - gap, left - gap)
//   dtw: M[i,j] = |a_i - b_j| + min(diag, up, left)
//
// from the tile's top row, left column and corner. Boundary rules (i = row,
// j = k - i on anti-diagonal k; D_k the values of diagonal k):
//   up   = top[j]  if i == 0 else D_{k-1}[i-1]
//   left = left[i] if j == 0 else D_{k-1}[i]
//   diag = corner if i == 0 and j == 0, top[j-1] if i == 0,
//          left[i-1] if j == 0, else D_{k-2}[i-1]
//
// What bounds it on this card: the tr+tc-1 dependent anti-diagonals, each
// ended by a block barrier, and, as the read mapper drives it one tile per
// launch from a Python wavefront loop, the launch itself. A 64x64 tile moves
// about 18 KB and does about 25 K simple fp32 operations: nanoseconds of
// bandwidth or arithmetic against microseconds of barriers and launch.
//
// What the design does about it: one CTA per tile, tr threads, thread i owns
// row i and sweeps the anti-diagonals. The previous diagonal lives in a
// ping-pong pair of shared buffers, so one __syncthreads per diagonal
// suffices; D_{k-2}[i-1] is the up value the thread read one step earlier,
// kept in a register. The tile is staged row-major in shared memory (16 KB
// at 64x64; the stride tc-1 between rows of one diagonal avoids bank
// conflicts) and written out coalesced with its bottom row, right column
// and corner, so no diagonal-major relayout follows. Leading batch
// dimensions map to blockIdx.x, so one launch serves a batch of tiles.
// Characters are compared as integers (kind "sw" takes int32 inputs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 128;
constexpr int kSW = 0;
constexpr int kDTW = 1;

template <int KIND, typename In>
__global__ void __launch_bounds__(kMaxTile)
dp_tile_kernel(const float* __restrict__ top, const float* __restrict__ left,
               const float* __restrict__ corner, const In* __restrict__ a,
               const In* __restrict__ b, float* __restrict__ tile,
               float* __restrict__ bottom, float* __restrict__ right,
               float* __restrict__ corner_out, int tr, int tc,
               long long s_top, long long s_left, long long s_corner,
               long long s_a, long long s_b, float match, float mismatch,
               float gap) {
  extern __shared__ float smem[];
  float* tile_s = smem;               // (tr, tc) row-major
  float* buf0 = tile_s + tr * tc;     // diagonal k even
  float* buf1 = buf0 + tr;            // diagonal k odd
  float* top_s = buf1 + tr;           // (tc,)
  In* b_s = reinterpret_cast<In*>(top_s + tc);  // (tc,)

  const int i = threadIdx.x;
  const long long p = blockIdx.x;
  top += p * s_top;
  left += p * s_left;
  corner += p * s_corner;
  a += p * s_a;
  b += p * s_b;

  for (int j = i; j < tc; j += blockDim.x) {
    top_s[j] = top[j];
    b_s[j] = b[j];
  }
  const In ai = a[i];
  const float left_i = left[i];
  const float left_im1 = i > 0 ? left[i - 1] : 0.f;
  const float c0 = corner[0];
  float prev_up = 0.f;   // up value of the previous diagonal = diag now
  __syncthreads();

  for (int k = 0; k < tr + tc - 1; ++k) {
    const int j = k - i;
    float* cur = (k & 1) ? buf1 : buf0;
    const float* prv = (k & 1) ? buf0 : buf1;
    if (j >= 0 && j < tc) {
      const float up = i == 0 ? top_s[j] : prv[i - 1];
      const float lf = j == 0 ? left_i : prv[i];
      float dg;
      if (i == 0) {
        dg = j == 0 ? c0 : top_s[j - 1];
      } else {
        dg = j == 0 ? left_im1 : prev_up;
      }
      float v;
      if (KIND == kSW) {
        const float sub = ai == b_s[j] ? match : mismatch;
        v = fmaxf(dg + sub, fmaxf(up - gap, lf - gap));
        v = fmaxf(v, 0.f);
      } else {
        v = fabsf((float)ai - (float)b_s[j]) + fminf(dg, fminf(up, lf));
      }
      cur[i] = v;
      tile_s[i * tc + j] = v;
      prev_up = up;
    }
    __syncthreads();
  }

  const long long base = p * (long long)tr * tc;
  for (int e = i; e < tr * tc; e += blockDim.x) tile[base + e] = tile_s[e];
  for (int j = i; j < tc; j += blockDim.x) {
    bottom[p * tc + j] = tile_s[(tr - 1) * tc + j];
  }
  right[p * tr + i] = tile_s[i * tc + tc - 1];
  if (i == 0) corner_out[p] = tile_s[tr * tc - 1];
}

template <int KIND, typename In>
int launch(const void* top, const void* left, const void* corner,
           const void* a, const void* b, void* tile, void* bottom,
           void* right, void* corner_out, int batch, int tr, int tc,
           long long s_top, long long s_left, long long s_corner,
           long long s_a, long long s_b, float match, float mismatch,
           float gap, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t max_smem =
      sizeof(float) * (kMaxTile * kMaxTile + 3 * kMaxTile) +
      sizeof(In) * kMaxTile;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        dp_tile_kernel<KIND, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t smem =
      sizeof(float) * ((size_t)tr * tc + 2 * tr + tc) + sizeof(In) * tc;
  dp_tile_kernel<KIND, In><<<batch, tr, smem, stream>>>(
      (const float*)top, (const float*)left, (const float*)corner,
      (const In*)a, (const In*)b, (float*)tile, (float*)bottom,
      (float*)right, (float*)corner_out, tr, tc, s_top, s_left, s_corner,
      s_a, s_b, match, mismatch, gap);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0 = sw (a, b int32), kind 1 = dtw (a, b float32). Strides are the
// element distance between consecutive tiles of a batch.
extern "C" int dp_tile_launch(int kind, const void* top, const void* left,
                              const void* corner, const void* a,
                              const void* b, void* tile, void* bottom,
                              void* right, void* corner_out, int batch,
                              int tr, int tc, long long s_top,
                              long long s_left, long long s_corner,
                              long long s_a, long long s_b, float match,
                              float mismatch, float gap, int device,
                              void* stream) {
  if (tr < 1 || tr > kMaxTile || tc < 1 || tc > kMaxTile || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kSW) {
    return launch<kSW, int32_t>(top, left, corner, a, b, tile, bottom, right,
                                corner_out, batch, tr, tc, s_top, s_left,
                                s_corner, s_a, s_b, match, mismatch, gap, st);
  }
  if (kind == kDTW) {
    return launch<kDTW, float>(top, left, corner, a, b, tile, bottom, right,
                               corner_out, batch, tr, tc, s_top, s_left,
                               s_corner, s_a, s_b, match, mismatch, gap, st);
  }
  return (int)cudaErrorInvalidValue;
}
