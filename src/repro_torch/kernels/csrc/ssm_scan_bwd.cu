// The backward of the WKV recurrence (csrc/ssm_scan.cu), hand-written for
// Hopper.
//
// Replaces: nothing on the TPU. The TPU kernel
// (src/repro/kernels/ssm_scan.py, ssm_scan_pallas) has no backward: the JAX
// package trains through the jnp wkv_chunked. The port runs the forward
// kernel in train mode, so its gradient is a kernel too.
//
// Forward (state S: dk x dv, S_0 = s0 or 0):
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// Backward, with G_t = dL/dS_t (G_T = the final state's gradient, or 0):
//     dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t^T
//     dk_t = (G_t + diag(r_t u) 1 dy_t) v_t^T          (row-wise)
//     dv_t = k_t (G_t + diag(r_t u) 1 dy_t)
//     dw_t = rowsum(G_t (.) S_{t-1})
//     du   = sum_t r_t (.) k_t (dy_t . v_t)
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t,             ds0 = G_0
//
// The trap is S_{t-1}: the backward walks t down, and undoing a step by
// dividing by w overflows over 2,048 steps. So each CTA first runs the
// forward again from s0, keeping the state at every chunk boundary (every
// kC steps) in global scratch; then it walks the chunks from the last to
// the first, recomputes the chunk's kC states from its checkpoint into
// shared memory, and runs the chunk's steps backward against them.
//
// Where the work splits: as in the forward, the state's value columns are
// independent, and so are G's. A CTA owns one row b (a batch-head pair) and
// 16 value columns, with the forward's lane layout (each lane a 4 x 4 tile
// of S and of G). dv and the carried G stay inside the CTA (dv's sum over
// the dk rows is the forward's butterfly). dr, dk and dw sum over all dv
// columns, that is over the CTAs of a row: each CTA writes its partial
// (its 16 columns) and a second kernel adds the dv / 16 partials in order;
// du sums over every row and step, so a third adds the per-CTA partials.
// No floating-point atomics: two launches give the same bits.
//
// What bounds it on this card: issue, as for the forward. Bytes are the
// inputs and dy read once, the gradients written once (about 0.2 ms at the
// train shape B=128, T=2048, dk=dv=64); the serial chain is three passes of
// the forward's step plus the backward step. This first version also moves
// its scratch through device memory: B * dv/16 * T/16 checkpoints of 4 KB
// (268 MB at the train shape) and the column partials (3 x dv/16 x B*T*dk
// fp32, 805 MB). Reducing across a row's CTAs through a thread block
// cluster's shared memory would remove the partials; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 64;                    // dk <= kDK
constexpr int kDVMax = 128;                // dv <= kDVMax
constexpr int kThreads = 64;               // 2 warps
constexpr int kCols = 16;                  // value columns per CTA, 8 a warp
constexpr int kC = 16;                     // steps per chunk (checkpoint)

struct Stage {
  float r[kC][kDK];
  float w[kC][kDK];
  float k[kC][kDK];
  float v[kC][kCols];
  float dy[kC][kCols];
};

struct Smem {
  Stage st;
  float4 stash[kC][4][kThreads];    // S_{t-1}: row 4a + e of lane tid
  float rows[kC][3][2][kDK];        // dr, dk, dw partials per warp
  float sp[kC][kCols][4];           // dv partials, the forward's layout
};

// steps t0 .. t0 + n - 1 of r, w, k (rows < dk, zero above) and of v and
// dy (columns c0 .. c0 + ncol - 1, zero above) into the stage
__device__ __forceinline__ void stage(Stage& S, const float* r,
                                      const float* w, const float* k,
                                      const float* v, const float* dy, int t0,
                                      int n, int dk, int dv, int ncol) {
  for (int e = threadIdx.x; e < kC * kDK; e += kThreads) {
    const int tt = e / kDK;
    const int i = e - tt * kDK;
    const bool in = tt < n && i < dk;
    const size_t g = (size_t)(t0 + tt) * dk + i;
    S.r[tt][i] = in ? r[g] : 0.f;
    S.w[tt][i] = in ? w[g] : 0.f;
    S.k[tt][i] = in ? k[g] : 0.f;
  }
  for (int e = threadIdx.x; e < kC * kCols; e += kThreads) {
    const int tt = e / kCols;
    const int c = e - tt * kCols;
    const bool in = tt < n && c < ncol;
    const size_t g = (size_t)(t0 + tt) * dv + c;
    S.v[tt][c] = in ? v[g] : 0.f;
    S.dy[tt][c] = (in && dy != nullptr) ? dy[g] : 0.f;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

// the last two levels of the butterfly, in its order: (p0 + p2) + (p1 + p3)
__device__ __forceinline__ float colsum(const float (&p)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return (q.x + q.z) + (q.y + q.w);
}

__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ w,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    const float* __restrict__ dy,
                    const float* __restrict__ ds_final,
                    float* __restrict__ dv_out, float* __restrict__ ds0,
                    float4* __restrict__ ckpt, float* __restrict__ part,
                    float* __restrict__ du_part, int B, int T, int dk,
                    int dv) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int a = tid & 15;                   // rows 4a .. 4a+3
  const int cb = 4 * (tid / 16);            // columns cb .. cb + 3
  const int warp = tid / 32;
  const int ncb = (dv + kCols - 1) / kCols;
  const int cbi = blockIdx.x % ncb;
  const size_t b = blockIdx.x / ncb;
  const int c0 = cbi * kCols;
  const int ncol = min(kCols, dv - c0);
  const int nchunks = (T + kC - 1) / kC;
  r += b * (size_t)T * dk;
  w += b * (size_t)T * dk;
  k += b * (size_t)T * dk;
  v += b * (size_t)T * dv + c0;
  dy += b * (size_t)T * dv + c0;
  dv_out += b * (size_t)T * dv + c0;
  ckpt += (size_t)blockIdx.x * nchunks * 4 * kThreads;

  float s[4][4], g[4][4], uu[4], du_acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * a + e;
    uu[e] = (u != nullptr && i < dk) ? u[i] : 0.f;
    du_acc[e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = i < dk && cb + c < ncol;
      const size_t at = (b * dk + i) * dv + c0 + cb + c;
      s[e][c] = (in && s0 != nullptr) ? s0[at] : 0.f;
      g[e][c] = (in && ds_final != nullptr) ? ds_final[at] : 0.f;
    }
  }

  // pass 1: the forward again, keeping the state at every chunk start
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kC;
    const int n = min(kC, T - t0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ckpt[((size_t)c * 4 + e) * kThreads + tid] =
          make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
    }
    __syncthreads();   // the previous chunk's readers are done
    stage(sm.st, r, w, k, v, nullptr, t0, n, dk, dv, ncol);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      float ww[4], kk[4], vv[4];
      load4(&sm.st.w[tt][4 * a], ww);
      load4(&sm.st.k[tt][4 * a], kk);
      load4(&sm.st.v[tt][cb], vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s[e][cc] = fmaf(ww[e], s[e][cc], kk[e] * vv[cc]);
        }
      }
    }
  }

  // pass 2: the chunks from the last to the first
  const size_t plane = (size_t)B * T * dk;          // one (q, cbi) partial
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, T - t0);
    __syncthreads();   // the previous chunk's readers are done
    stage(sm.st, r, w, k, v, dy, t0, n, dk, dv, ncol);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 q = ckpt[((size_t)c * 4 + e) * kThreads + tid];
      s[e][0] = q.x;
      s[e][1] = q.y;
      s[e][2] = q.z;
      s[e][3] = q.w;
    }
    for (int tt = 0; tt < n; ++tt) {          // S_{t-1} of each step
      float ww[4], kk[4], vv[4];
      load4(&sm.st.w[tt][4 * a], ww);
      load4(&sm.st.k[tt][4 * a], kk);
      load4(&sm.st.v[tt][cb], vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sm.stash[tt][e][tid] = make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s[e][cc] = fmaf(ww[e], s[e][cc], kk[e] * vv[cc]);
        }
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      float rr[4], ww[4], kk[4], vv[4], dd[4];
      load4(&sm.st.r[tt][4 * a], rr);
      load4(&sm.st.w[tt][4 * a], ww);
      load4(&sm.st.k[tt][4 * a], kk);
      load4(&sm.st.v[tt][cb], vv);
      load4(&sm.st.dy[tt][cb], dd);
      float dot = 0.f;                        // this lane's part of dy . v
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dot = fmaf(dd[cc], vv[cc], dot);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};    // dv, over this lane's rows
      float pr[4], pk[4], pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 q = sm.stash[tt][e][tid];
        const float sp[4] = {q.x, q.y, q.z, q.w};
        const float ru = rr[e] * uu[e];
        const float uk = uu[e] * kk[e];
        pr[e] = pk[e] = pw[e] = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float gb = fmaf(ru, dd[cc], g[e][cc]);   // G + r u dy
          acc[cc] = fmaf(kk[e], gb, acc[cc]);
          pk[e] = fmaf(vv[cc], gb, pk[e]);
          pr[e] = fmaf(dd[cc], fmaf(uk, vv[cc], sp[cc]), pr[e]);
          pw[e] = fmaf(g[e][cc], sp[cc], pw[e]);
          g[e][cc] = fmaf(ww[e], g[e][cc], rr[e] * dd[cc]);
        }
        du_acc[e] = fmaf(rr[e] * kk[e], dot, du_acc[e]);
      }
      // dv: each column over the 16 row groups, the forward's butterfly
      const bool h3 = a & 8, h2 = a & 4;
      float x0 = h3 ? acc[2] : acc[0];
      float x1 = h3 ? acc[3] : acc[1];
      x0 += __shfl_xor_sync(0xffffffffu, h3 ? acc[0] : acc[2], 8);
      x1 += __shfl_xor_sync(0xffffffffu, h3 ? acc[1] : acc[3], 8);
      float yy = h2 ? x1 : x0;
      yy += __shfl_xor_sync(0xffffffffu, h2 ? x0 : x1, 4);
      sm.sp[tt][cb + (a >> 2)][a & 3] = yy;
      // dr, dk, dw: this warp's 8 columns (the lane with the other 4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] += __shfl_xor_sync(0xffffffffu, pr[e], 16);
        pk[e] += __shfl_xor_sync(0xffffffffu, pk[e], 16);
        pw[e] += __shfl_xor_sync(0xffffffffu, pw[e], 16);
      }
      if ((tid & 16) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sm.rows[tt][0][warp][4 * a + e] = pr[e];
          sm.rows[tt][1][warp][4 * a + e] = pk[e];
          sm.rows[tt][2][warp][4 * a + e] = pw[e];
        }
      }
    }
    __syncthreads();   // sp and rows complete
    for (int e = tid; e < n * ncol; e += kThreads) {
      const int tt = e / ncol;
      const int cc = e - tt * ncol;
      dv_out[(size_t)(t0 + tt) * dv + cc] = colsum(sm.sp[tt][cc]);
    }
    for (int e = tid; e < 3 * n * dk; e += kThreads) {
      const int q = e / (n * dk);
      const int rest = e - q * n * dk;
      const int tt = rest / dk;
      const int i = rest - tt * dk;
      part[(size_t)(q * ncb + cbi) * plane + (b * T + t0 + tt) * dk + i] =
          sm.rows[tt][q][0][i] + sm.rows[tt][q][1][i];
    }
  }

  if (ds0 != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * a + e;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (i < dk && cb + cc < ncol) {
          ds0[(b * dk + i) * dv + c0 + cb + cc] = g[e][cc];
        }
      }
    }
  }
  if (du_part != nullptr) {
    __syncthreads();   // rows is free
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      du_acc[e] += __shfl_xor_sync(0xffffffffu, du_acc[e], 16);
      if ((tid & 16) == 0) sm.rows[0][0][warp][4 * a + e] = du_acc[e];
    }
    __syncthreads();
    for (int i = tid; i < dk; i += kThreads) {
      du_part[(size_t)blockIdx.x * dk + i] =
          sm.rows[0][0][0][i] + sm.rows[0][0][1][i];
    }
  }
}

// dr, dk, dw (B, T, dk): the dv / 16 column partials added in order
__global__ void __launch_bounds__(256)
ssm_bwd_rows_kernel(const float* __restrict__ part, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dw, int ncb,
                    size_t plane) {
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < plane;
       e += (size_t)gridDim.x * 256) {
    float acc[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < 3; ++q) {
      for (int cbi = 0; cbi < ncb; ++cbi) {
        acc[q] += part[(size_t)(q * ncb + cbi) * plane + e];
      }
    }
    dr[e] = acc[0];
    dk[e] = acc[1];
    dw[e] = acc[2];
  }
}

// du (dk,): the per-CTA partials added in CTA order
__global__ void ssm_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int ctas, int dk) {
  for (int i = threadIdx.x; i < dk; i += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < ctas; ++c) acc += du_part[(size_t)c * dk + i];
    du[i] = acc;
  }
}

}  // namespace

// r, w, k (B, T, dk), v and dy (B, T, dv), fp32 contiguous; u (dk), s0 and
// ds_final (B, dk, dv) or null. Writes dr, dw, dk (B, T, dk), dv (B, T,
// dv), du (dk) when u is given and ds0 (B, dk, dv) when s0 is given.
// Scratch from the caller, fp32: ckpt of B * ceil(dv / 16) * ceil(T / 16) *
// 1,024 floats (16-byte aligned), part of 3 * ceil(dv / 16) * B * T * dk,
// du_part of B * ceil(dv / 16) * dk (null without u).
extern "C" int ssm_scan_bwd_launch(
    const void* r, const void* w, const void* k, const void* v,
    const void* u, const void* s0, const void* dy, const void* ds_final,
    void* dr, void* dw, void* dk_out, void* dv_out, void* du, void* ds0,
    void* ckpt, void* part, void* du_part, int B, int T, int dk, int dv,
    int device, void* stream) {
  if (B < 1 || T < 1 || dk < 1 || dk > kDK || dv < 1 || dv > kDVMax ||
      (u != nullptr) != (du != nullptr) ||
      (u != nullptr) != (du_part != nullptr) ||
      (s0 != nullptr) != (ds0 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int ncb = (dv + kCols - 1) / kCols;
  const long long ctas = (long long)B * ncb;
  const int bytes = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(ssm_scan_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_bwd_kernel<<<(unsigned)ctas, kThreads, bytes, st>>>(
      (const float*)r, (const float*)w, (const float*)k, (const float*)v,
      (const float*)u, (const float*)s0, (const float*)dy,
      (const float*)ds_final, (float*)dv_out, (float*)ds0, (float4*)ckpt,
      (float*)part, (float*)du_part, B, T, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)B * T * dk;
  const size_t want = (plane + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  ssm_bwd_rows_kernel<<<blocks, 256, 0, st>>>(
      (const float*)part, (float*)dr, (float*)dk_out, (float*)dw, ncb, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (u != nullptr) {
    ssm_bwd_du_kernel<<<1, 64, 0, st>>>((const float*)du_part, (float*)du,
                                        (int)ctas, dk);
    err = cudaGetLastError();
  }
  return (int)err;
}
