// The 2-D DP wavefront (Smith-Waterman or DTW), hand-written for Hopper: one
// tile (dp_tile) and the whole tile wavefront in one launch (dp_wavefront).
//
// Replaces: src/repro/kernels/dtw_wavefront.py, dp_tile_pallas (kernel body
// _dp_tile_kernel), the TPU kernel of the read mapper's align stage
// (kind "sw") and of the tiled DTW (kind "dtw"), with the Python loop over
// tiles around it (src/repro/core/wavefront.py, run_wavefront).
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
// dp_tile. What bounds it on this card: the tr+tc-1 dependent
// anti-diagonals, each ended by a block barrier, and, driven one tile per
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
//
// dp_wavefront: the whole tile wavefront of one DP matrix (or a batch of
// them) in one cooperative launch, Squire's Alg. 4 on Hopper. The
// reference walks the tiles from Python, one tile call per tile; here one
// launch replaces that loop, and dp_tile stays as the counterpart of the
// reference's tile-fn contract.
//
//   Work: the matrix is cut into column strips of tc columns. Strip s
//   (= batch item * nc + column tile) belongs to CTA s mod G, and each CTA
//   takes its strips in increasing order. A CTA is one warp and walks its
//   strip from the top row tile to the bottom one.
//   Hand-off: each strip keeps a monotone counter of the row tiles it has
//   finished (Squire's local counter): after writing a tile to the
//   assembled matrix, every lane fences and lane 0 stores the count with
//   st.release.gpu. The strip to its right spins on that counter with
//   ld.acquire.gpu before it reads the tile's right column (and the
//   corner above it) from the matrix in L2 (ld.global.cg). Each strip waits
//   only on the strip to its left and strips go to CTAs in order, so with
//   every CTA resident (cooperative launch, grid <= occupancy x SMs) the
//   lowest unfinished strip can always move: no deadlock.
//   Inside a tile there is no barrier: lane l owns rows R*l .. R*l+R-1
//   (R = ceil(tr / 32)) and sweeps the columns skewed by one step per lane;
//   the value below its last row goes to lane l+1 by __shfl_up_sync, the
//   top row comes from the strip's previous tile in shared memory. The
//   tile is staged in shared memory (row stride tc: the skew puts the 32
//   lanes on 32 banks) and written out row by row, coalesced.
//   Every cell is the tile's own formula on the same fp32 values, so the
//   result equals the plain tile loop bit for bit in any visiting order.
//
// What bounds it: the bytes of the assembled matrix it must write (4 per
// cell). What sets its time: the pipeline depth nr + nc - 1 tile steps of
// tc + L - 1 dependent shuffle steps each (L = lanes in use), plus one
// counter hand-off through L2 per step.

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


constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

template <int KIND, typename In>
__device__ __forceinline__ float dp_cell(float dg, float up, float lf, In av,
                                         In bv, float match, float mismatch,
                                         float gap) {
  if (KIND == kSW) {
    const float sub = av == bv ? match : mismatch;
    return fmaxf(fmaxf(dg + sub, fmaxf(up - gap, lf - gap)), 0.f);
  }
  return fabsf((float)av - (float)bv) + fminf(dg, fminf(up, lf));
}

// E(i, j0 - 1), the column left of a strip, with row -1 the top boundary:
// the input boundary for the first strip, else the assembled matrix (read
// through L2: another SM wrote it).
__device__ __forceinline__ float left_of_strip(int i, int c, int j0,
                                               const float* left,
                                               const float* top, float corner,
                                               const float* M, int m) {
  if (i < 0) return j0 == 0 ? corner : top[j0 - 1];
  if (c == 0) return left[i];
  return __ldcg(M + (long long)i * m + j0 - 1);
}

template <int KIND, int R, typename In>
__global__ void __launch_bounds__(32)
dp_wavefront_kernel(const In* __restrict__ a, const In* __restrict__ b,
                    const float* __restrict__ top0,
                    const float* __restrict__ left0,
                    const float* __restrict__ corner0, float* mat,
                    unsigned* done, int batch, int n, int m, int tr, int tc,
                    float match, float mismatch, float gap) {
  extern __shared__ float smem[];
  float* tile_s = smem;                          // (tr, tc) row-major
  float* top_s = tile_s + tr * tc;               // (tc,)
  In* b_s = reinterpret_cast<In*>(top_s + tc);   // (tc,)

  const int lane = threadIdx.x;
  const int nr = n / tr, nc = m / tc;
  const int lanes = (tr + R - 1) / R;            // lanes that own rows
  const bool owner = lane < lanes;
  const long long strips = (long long)batch * nc;

  for (long long s = blockIdx.x; s < strips; s += gridDim.x) {
    const int bi = (int)(s / nc);
    const int c = (int)(s - (long long)bi * nc);
    const int j0 = c * tc;
    const In* ab = a + (long long)bi * n;
    const In* bb = b + (long long)bi * m;
    const float* tb = top0 + (long long)bi * m;
    const float* lb = left0 + (long long)bi * n;
    const float cor = corner0[bi];
    float* M = mat + (long long)bi * n * m;

    __syncwarp();   // the previous strip's readers of b_s and top_s are done
    for (int x = lane; x < tc; x += 32) {
      b_s[x] = bb[j0 + x];
      top_s[x] = tb[j0 + x];
    }
    unsigned avail = 0;   // row tiles the left strip is known to have done
    for (int r = 0; r < nr; ++r) {
      const int i0 = r * tr;
      if (c > 0 && avail <= (unsigned)r) {
        if (lane == 0) {
          unsigned v;
          do {
            v = ld_acquire(done + s - 1);
          } while (v <= (unsigned)r);
          avail = v;
        }
        avail = __shfl_sync(kFull, avail, 0);
      }
      __syncwarp();   // lane 0's acquire orders every lane's reads below

      float lft[R];
      In av[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int row = R * lane + q;
        lft[q] = 0.f;
        av[q] = In(0);
        if (row < tr) {
          lft[q] = left_of_strip(i0 + row, c, j0, lb, tb, cor, M, m);
          av[q] = ab[i0 + row];
        }
      }
      const float dg_first =
          owner ? left_of_strip(i0 + R * lane - 1, c, j0, lb, tb, cor, M, m)
                : 0.f;

      // The sweep has no branch: every lane computes at every step, on a
      // clamped column before its start and after its end (values nobody
      // reads: a lane's first column takes lft and dg_first, and a lane's
      // output reaches the next lane only at that lane's own column), and
      // only the stores to the staged tile are predicated.
      float prev[R];
#pragma unroll
      for (int q = 0; q < R; ++q) prev[q] = 0.f;
      float up_prev = 0.f, recv = 0.f;
      const int steps = tc + lanes - 1;
      int jc = min(max(-lane, 0), tc - 1);
      float top_j = top_s[jc];
      In b_j = b_s[jc];
      for (int k = 0; k < steps; ++k) {
        const int j = k - lane;
        const float up_in = lane == 0 ? top_j : recv;
        const In bj = b_j;
        jc = min(max(j + 1, 0), tc - 1);         // the next step's column
        top_j = top_s[jc];
        b_j = b_s[jc];
        float cur[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float up = q == 0 ? up_in : cur[q - 1];
          const float lf = j == 0 ? lft[q] : prev[q];
          float dg;
          if (q == 0) {
            dg = j == 0 ? dg_first : up_prev;
          } else {
            dg = j == 0 ? lft[q - 1] : prev[q - 1];
          }
          cur[q] = dp_cell<KIND, In>(dg, up, lf, av[q], bj, match, mismatch,
                                     gap);
        }
        const bool in_tile = owner && j >= 0 && j < tc;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          prev[q] = cur[q];
          if (in_tile && R * lane + q < tr) {
            tile_s[(R * lane + q) * tc + j] = cur[q];
          }
        }
        up_prev = up_in;
        recv = __shfl_up_sync(kFull, cur[R - 1], 1);
      }
      __syncwarp();

      // write-out: 16-byte chunks, 32 / (tc / 4) rows per warp store
      const int chunks = tc / 4;
      if (tc % 4 == 0 && chunks <= 32 && 32 % chunks == 0) {
        const int rows_per_store = 32 / chunks;
        const int r0 = lane / chunks;
        const float4* src =
            reinterpret_cast<const float4*>(tile_s) + lane;
        float4* dst = reinterpret_cast<float4*>(
                          M + (long long)(i0 + r0) * m + j0) + lane % chunks;
        const long long dst_step = (long long)rows_per_store * m / 4;
#pragma unroll 4
        for (int rr = r0; rr < tr; rr += rows_per_store) {
          *dst = *src;
          src += 32;
          dst += dst_step;
        }
      } else {
        for (int rr = 0; rr < tr; ++rr) {
          float* dst = M + (long long)(i0 + rr) * m + j0;
          const float* src = tile_s + rr * tc;
          for (int x = lane; x < tc; x += 32) dst[x] = src[x];
        }
      }
      for (int x = lane; x < tc; x += 32) top_s[x] = tile_s[(tr - 1) * tc + x];
      __threadfence();   // this lane's part of the tile, before the count
      __syncwarp();
      if (lane == 0) st_release(done + s, (unsigned)(r + 1));
    }
  }
}

template <int KIND, int R, typename In>
int launch_wavefront(const void* a, const void* b, const void* top0,
                     const void* left0, const void* corner0, void* mat,
                     void* done, int batch, int n, int m, int tr, int tc,
                     float match, float mismatch, float gap, int device,
                     cudaStream_t stream, int* grid_out) {
  auto kern = dp_wavefront_kernel<KIND, R, In>;
  const size_t smem =
      sizeof(float) * ((size_t)tr * tc + tc) + sizeof(In) * tc;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, coop = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long strips = (long long)batch * (m / tc);
  long long grid = (long long)per_sm * sms;
  if (strips < grid) grid = strips;
  *grid_out = (int)grid;

  const In* a_ = (const In*)a;
  const In* b_ = (const In*)b;
  const float* t_ = (const float*)top0;
  const float* l_ = (const float*)left0;
  const float* c_ = (const float*)corner0;
  float* mat_ = (float*)mat;
  unsigned* done_ = (unsigned*)done;
  void* args[] = {&a_, &b_, &t_, &l_, &c_, &mat_, &done_, &batch, &n, &m,
                  &tr, &tc, &match, &mismatch, &gap};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid),
                                    dim3(32), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KIND, typename In>
int dispatch_rows(int rows_per_lane, const void* a, const void* b,
                  const void* top0, const void* left0, const void* corner0,
                  void* mat, void* done, int batch, int n, int m, int tr,
                  int tc, float match, float mismatch, float gap, int device,
                  cudaStream_t stream, int* grid_out) {
  switch (rows_per_lane) {
    case 1: return launch_wavefront<KIND, 1, In>(a, b, top0, left0, corner0, mat, done, batch, n, m, tr, tc, match, mismatch, gap, device, stream, grid_out);
    case 2: return launch_wavefront<KIND, 2, In>(a, b, top0, left0, corner0, mat, done, batch, n, m, tr, tc, match, mismatch, gap, device, stream, grid_out);
    case 3: return launch_wavefront<KIND, 3, In>(a, b, top0, left0, corner0, mat, done, batch, n, m, tr, tc, match, mismatch, gap, device, stream, grid_out);
    case 4: return launch_wavefront<KIND, 4, In>(a, b, top0, left0, corner0, mat, done, batch, n, m, tr, tc, match, mismatch, gap, device, stream, grid_out);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The whole wavefront in one cooperative launch. a (batch, n), b (batch, m),
// top0 (batch, m), left0 (batch, n), corner0 (batch,) and the matrix
// (batch, n, m) are contiguous; done (batch * m / tc) is zeroed by the
// caller. The grid (every CTA the card holds at once, at most one per
// strip) is written to *grid_out.
extern "C" int dp_wavefront_launch(int kind, const void* a, const void* b,
                                   const void* top0, const void* left0,
                                   const void* corner0, void* mat,
                                   void* done, int batch, int n, int m,
                                   int tr, int tc, float match,
                                   float mismatch, float gap, int device,
                                   void* stream, int* grid_out) {
  if (tr < 1 || tr > kMaxTile || tc < 1 || tc > kMaxTile || batch < 1 ||
      n < tr || m < tc || n % tr != 0 || m % tc != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows_per_lane = (tr + 31) / 32;
  if (kind == kSW) {
    return dispatch_rows<kSW, int32_t>(rows_per_lane, a, b, top0, left0,
                                       corner0, mat, done, batch, n, m, tr,
                                       tc, match, mismatch, gap, device, st,
                                       grid_out);
  }
  if (kind == kDTW) {
    return dispatch_rows<kDTW, float>(rows_per_lane, a, b, top0, left0,
                                      corner0, mat, done, batch, n, m, tr,
                                      tc, match, mismatch, gap, device, st,
                                      grid_out);
  }
  return (int)cudaErrorInvalidValue;
}
