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
// What bounds it on this card: issue, not the recurrence. Bytes are
// B*T*(3*dk + 2*dv)*4 (about 0.1 ms at the prefill shape B=128, T=2048,
// dk=dv=64) and operations about 5*B*T*dk*dv (about 0.08 ms at fp32 peak).
// The only carried dependence is s_ij <- w_i s_ij + k_i v_j, one FMA per
// step and state element; columns j are independent, and so are the rows i
// of a column up to the readout's sum. So the time is what each SM issues
// per step: four fp32 instructions per state element, and the shared-memory
// loads that bring each lane the step's r, w, k of its rows and v of its
// columns (one delivery per 4-byte value per lane).
//
// What the design does about it: the TPU carried the state in VMEM scratch
// across the ordered chunk axis of its grid; here the time axis is a loop
// inside each CTA, and the (dk x dv) state of every row b is spread over
// the card as 4 x 4 register tiles. A warp holds 8 value columns: lane l
// takes the 4 state rows 4a .. 4a+3 (a = l mod 16) of the 4 columns 4h ..
// 4h+3 (h = l / 16) of its warp's 8. A CTA is 2 warps (16 columns), so at
// B=128, dv=64 the grid is 512 CTAs and each SM holds about 8 warps,
// against 2 with one thread per column. Per step a lane reads r, w and k of
// its rows and v of its columns as four float4 loads (no bank conflict):
// 16 values for 16 state elements, where a lane per column (or a few lanes
// per column) needs 3 values per element and leaves the card waiting on
// shared memory. The lane updates its 16 elements with the plain version's
// formula and sums r_i (s_ij + u_i k_i v_j) over its 4 rows per column; the
// 16 row groups of a column are then added by a transposing butterfly over
// the half-warp, xor 8 and xor 4 halving the columns a lane keeps (3
// shuffles per step, after the state update, off the carried chain), and
// the last four partials from shared memory after the chunk. A chunk of kC
// steps is unrolled with no store between its steps, so the next step's
// loads and FMAs issue while this one's shuffles are in flight. The inputs
// of a chunk are staged in shared memory by cp.async into two buffers, so
// the next chunk lands while this one computes; y of a chunk leaves with
// 16-byte stores. The inputs are fp32, as the TPU kernel's, and so is
// every operation inside.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 64;                    // dk <= kDK
constexpr int kDVMax = 128;                // dv <= kDVMax
constexpr int kThreads = 64;               // 2 warps
constexpr int kCols = 16;                  // value columns per CTA, 8 a warp
constexpr int kC = 16;                     // time steps per staged chunk
// 16-byte pieces a thread copies per chunk: of r, w and k each, and of v
constexpr int kRKPieces = (kC * kDK / 4 + kThreads - 1) / kThreads;
constexpr int kVPieces = (kC * kCols / 4 + kThreads - 1) / kThreads;

struct Stage {
  float r[kC][kDK];
  float w[kC][kDK];
  float k[kC][kDK];
  float v[kC][kCols];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
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

// One time step of one lane: rows 4a .. 4a+3 of columns cb .. cb+3.
// Updates the lane's state tile s[e][c] and returns the partial readout sum
// that this lane ends up holding: column cb + 2*h3 + h2 (h3 and h2 bits 3
// and 2 of a) over the row groups a, a^4, a^8 and a^12.
__device__ __forceinline__ float wkv_step(const Stage& S, int tt, int a,
                                          int cb, const float (&uu)[4],
                                          float (&s)[4][4]) {
  const float4 r4 = *reinterpret_cast<const float4*>(&S.r[tt][4 * a]);
  const float4 w4 = *reinterpret_cast<const float4*>(&S.w[tt][4 * a]);
  const float4 k4 = *reinterpret_cast<const float4*>(&S.k[tt][4 * a]);
  const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
  const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
  const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
  const float4 v4 = *reinterpret_cast<const float4*>(&S.v[tt][cb]);
  const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float kv = kk[e] * vv[c];
      acc[c] = fmaf(rr[e], fmaf(uu[e], kv, s[e][c]), acc[c]);   // S_{t-1}
      s[e][c] = fmaf(ww[e], s[e][c], kv);
    }
  }
  // sum each column over row groups of the half-warp: xor 8 keeps columns
  // {0,1} or {2,3}, xor 4 one of them; the last four partials of a column
  // are added from shared memory after the chunk
  const bool h3 = a & 8, h2 = a & 4;
  float x0 = h3 ? acc[2] : acc[0];
  float x1 = h3 ? acc[3] : acc[1];
  x0 += __shfl_xor_sync(0xffffffffu, h3 ? acc[0] : acc[2], 8);
  x1 += __shfl_xor_sync(0xffffffffu, h3 ? acc[1] : acc[3], 8);
  float yy = h2 ? x1 : x0;
  yy += __shfl_xor_sync(0xffffffffu, h2 ? x0 : x1, 4);
  return yy;
}

// the last two levels of the butterfly, in its order: (p0 + p2) + (p1 + p3)
__device__ __forceinline__ float colsum(const float (&p)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return (q.x + q.z) + (q.y + q.w);
}

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_final,
                int T, int dk, int dv, int vec) {
  __shared__ __align__(16) Stage st[2];
  // a chunk's readout partials: sp[tt][col][q] sums row groups a with a
  // mod 4 == q (and the other three that the butterfly folded in)
  __shared__ __align__(16) float sp[kC][kCols][4];

  const int tid = threadIdx.x;
  const int a = tid & 15;                   // rows 4a .. 4a+3
  const int cb = 4 * (tid / 16);            // columns cb .. cb + 3
  const int ncb = (dv + kCols - 1) / kCols;
  const size_t b = blockIdx.x / ncb;
  const int c0 = (blockIdx.x % ncb) * kCols;
  const int ncol = min(kCols, dv - c0);
  r += b * (size_t)T * dk;
  w += b * (size_t)T * dk;
  k += b * (size_t)T * dk;
  v += b * (size_t)T * dv + c0;
  y += b * (size_t)T * dv + c0;

  // rows at and past dk stay zero in both buffers (cp.async writes i < dk)
  for (int e = tid; e < 2 * kC * kDK; e += kThreads) {
    const int buf = e / (kC * kDK);
    const int tt = (e / kDK) % kC;
    const int i = e % kDK;
    if (i >= dk) {
      st[buf].r[tt][i] = 0.f;
      st[buf].w[tt][i] = 0.f;
      st[buf].k[tt][i] = 0.f;
    }
  }

  // 16-byte path: the (step, offset) pairs this thread copies are the same
  // in every chunk, so they are computed once: pieces e = tid + kThreads q
  // of the chunk's r, w and k rows, and of its v and y rows
  const int per = dk / 4, pv = ncol / 4;
  int rk_t[kRKPieces], rk_i[kRKPieces], v_t[kVPieces], v_c[kVPieces];
#pragma unroll
  for (int q = 0; q < kRKPieces; ++q) {
    const int e = tid + kThreads * q;
    rk_t[q] = vec ? e / per : kC;           // kC: no piece
    rk_i[q] = vec ? (e - rk_t[q] * per) * 4 : 0;
  }
#pragma unroll
  for (int q = 0; q < kVPieces; ++q) {
    const int e = tid + kThreads * q;
    v_t[q] = vec ? e / pv : kC;
    v_c[q] = vec ? (e - v_t[q] * pv) * 4 : 0;
  }

  // steps t0 .. t0+n-1 into buffer buf, as one cp.async group
  auto issue = [&](int t0, int n, int buf) {
    Stage& S = st[buf];
    const size_t base = (size_t)t0 * dk;
    if (vec) {   // dk % 4 == 0, dv % 4 == 0, 16-byte aligned rows
#pragma unroll
      for (int q = 0; q < kRKPieces; ++q) {
        if (rk_t[q] < n) {
          const size_t g = base + (size_t)rk_t[q] * dk + rk_i[q];
          cp_async16(&S.r[rk_t[q]][rk_i[q]], r + g);
          cp_async16(&S.w[rk_t[q]][rk_i[q]], w + g);
          cp_async16(&S.k[rk_t[q]][rk_i[q]], k + g);
        }
      }
#pragma unroll
      for (int q = 0; q < kVPieces; ++q) {
        if (v_t[q] < n) {
          cp_async16(&S.v[v_t[q]][v_c[q]],
                     v + (size_t)(t0 + v_t[q]) * dv + v_c[q]);
        }
      }
    } else {
      for (int e = tid; e < n * dk; e += kThreads) {
        const int tt = e / dk;
        const int i = e - tt * dk;
        cp_async4(&S.r[tt][i], r + base + e);
        cp_async4(&S.w[tt][i], w + base + e);
        cp_async4(&S.k[tt][i], k + base + e);
      }
      for (int e = tid; e < n * ncol; e += kThreads) {
        const int tt = e / ncol;
        const int c = e - tt * ncol;
        cp_async4(&S.v[tt][c], v + (size_t)(t0 + tt) * dv + c);
      }
    }
    cp_async_commit();
  };

  float s[4][4], uu[4];    // s[e][c]: row 4a + e, column c0 + cb + c
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * a + e;
    uu[e] = (u != nullptr && i < dk) ? u[i] : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[e][c] = (s0 != nullptr && i < dk && cb + c < ncol)
                    ? s0[(b * dk + i) * dv + c0 + cb + c] : 0.f;
    }
  }

  const int nchunks = (T + kC - 1) / kC;
  if (nchunks > 0) issue(0, min(kC, T), 0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kC;
    const int n = min(kC, T - t0);
    if (c + 1 < nchunks) {
      issue(t0 + kC, min(kC, T - t0 - kC), (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c (and the zeroed rows) visible to all

    const Stage& S = st[c & 1];
    float* ps = &sp[0][cb + (a >> 2)][a & 3];   // column 2*h3 + h2
    if (n == kC) {
      // a whole chunk, unrolled: nothing is stored between the steps, so
      // the next step's loads and FMAs issue while this step's shuffles
      // are in flight
      float ys[kC];
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) ys[tt] = wkv_step(S, tt, a, cb, uu, s);
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) ps[tt * kCols * 4] = ys[tt];
    } else {
      for (int tt = 0; tt < n; ++tt) {
        ps[tt * kCols * 4] = wkv_step(S, tt, a, cb, uu, s);
      }
    }
    __syncthreads();   // sp complete; buffer c & 1 free for chunk c + 2

    float* yc = y + (size_t)t0 * dv;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kVPieces; ++q) {
        const int tt = v_t[q], cc = v_c[q];
        if (tt < n) {
          float4 out;
          out.x = colsum(sp[tt][cc]);
          out.y = colsum(sp[tt][cc + 1]);
          out.z = colsum(sp[tt][cc + 2]);
          out.w = colsum(sp[tt][cc + 3]);
          *reinterpret_cast<float4*>(yc + (size_t)tt * dv + cc) = out;
        }
      }
    } else {
      for (int e = tid; e < n * ncol; e += kThreads) {
        const int tt = e / ncol;
        const int cc = e - tt * ncol;
        yc[(size_t)tt * dv + cc] = colsum(sp[tt][cc]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * a + e;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (i < dk && cb + c < ncol) {
        s_final[(b * dk + i) * dv + c0 + cb + c] = s[e][c];
      }
    }
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
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = (dk % 4 == 0 && dv % 4 == 0 && aligned(r) && aligned(w) &&
                   aligned(k) && aligned(v) && aligned(y)) ? 1 : 0;
  const long long grid = (long long)B * ((dv + kCols - 1) / kCols);
  ssm_scan_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)w, (const float*)k, (const float*)v,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_final, T, dk,
      dv, vec);
  return (int)cudaGetLastError();
}
