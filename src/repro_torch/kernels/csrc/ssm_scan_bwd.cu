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
// kC = 6 steps) in global scratch; then it walks the chunks from the last
// to the first, recomputes the chunk's states from its checkpoint into
// shared memory, and runs the chunk's steps backward against them.
//
// Where the work splits: as in the forward, the state's value columns are
// independent, and so are G's. A CTA owns one row b (a batch-head pair) and
// 16 value columns as 2 warps, each lane a 4 x 4 tile of S and of G: warp
// w's lane l holds rows 4a .. 4a + 3 (a = 8 w + l % 8) of columns 4 (l /
// 8) .. + 3, so a warp holds 32 rows of all 16 columns. dv and the carried
// G stay inside the CTA: dv's sum over the rows is a butterfly over the 8
// row groups of a warp (xor 4, 2, 1), the two warps' partials added after
// the chunk. dr, dk and dw sum over all dv columns, that is over the dv /
// 16 CTAs of a row: those CTAs form one thread-block cluster (at most 8,
// the portable size, as dv <= 128; the kernel is instantiated per size).
// Per step each CTA leaves its 16 columns' sums (a butterfly over the 4
// column groups of a row: xor 16, 8) in its shared memory, in one of two
// buffers by chunk parity. At the next chunk's start, one cluster
// barrier; then each thread issues the loads of its share of the finished
// chunk's sums from every rank (distributed shared memory, all in flight
// at once), recomputes the new chunk's states, and only then adds what
// arrived, in rank order, and writes dr, dk and dw: the remote loads'
// latency hides behind the recompute (across the backward steps the
// values would not fit the 168 registers a thread has). du sums over
// every row and step: the same cluster sum per row at the end, then a
// small kernel adds the rows in order. No floating-point atomics
// and a fixed order everywhere: two launches give the same bits.
//
// What bounds it on this card: issue latency, not bytes or operations.
// Bytes are the inputs and dy read once and the gradients written once
// (about 0.2 ms at the train shape B=128, T=2048, dk=dv=64); the serial
// chain is two passes of the forward's step plus the backward step, each a
// few dependent shared-memory loads, FMAs and shuffles per step. So what
// matters is that every CTA is resident at once and that nothing else
// waits on the chain: 45,312 bytes of shared memory a CTA (the stash of a
// chunk's states 24 KB, two stages of inputs 10.5 KB, the two buffers of
// column sums 9 KB, dv partials 0.75 KB) let 5 CTAs share an SM (4 did
// not: clusters of 4 then held 496 of the train shape's 512 CTAs), so the
// 512 CTAs run in one wave. Each chunk's r, w, k, v and dy are copied by
// cp.async (16-byte pieces where dk and dv are multiples of 4) into the
// second stage while the chunk before runs, and the next checkpoint into
// the stash slot that the chunk's first backward step frees; the forward rerun stages blocks of
// 18 steps into the stash's space, which it does not use. Scratch: B *
// dv/16 * T/6 checkpoints of 4 KB (717 MB at the train shape, written once
// and read once); no column-partial plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 64;                    // dk <= kDK
constexpr int kDVMax = 128;                // dv <= kDVMax
constexpr int kThreads = 64;               // 2 warps
constexpr int kCols = 16;                  // value columns per CTA
constexpr int kC = 6;                      // steps per chunk (checkpoint)
constexpr int kP1 = 3 * kC;                // steps per block of pass 1
constexpr int kMaxCluster = kDVMax / kCols;
constexpr unsigned kAll = 0xffffffffu;

template <int N>
struct Inputs {                            // N steps of w, k and v
  float w[N][kDK];
  float k[N][kDK];
  float v[N][kCols];
};

struct Stage : Inputs<kC> {                // one chunk's inputs in pass 2
  float r[kC][kDK];
  float dy[kC][kCols];
};

struct Smem {
  Stage st[2];                             // this chunk's and the next
  union {
    float4 stash[kC][4][kThreads];         // S_{t-1}: row 4a + e of lane tid
    Inputs<kP1> st1[2];                    // pass 1's blocks of inputs
  };
  float rows[2][kC][3][kDK];               // dr, dk, dw over the 16 columns
  float sp[kC][2][kCols];                  // dv per warp
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes, or as many zero bytes when !in
__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared-memory address `local` in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// x, which the compiler cannot see through: the cluster sum's index
// arithmetic, which does not change between chunks, is then redone in each
// chunk instead of being held in registers across the whole loop
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// steps t0 .. t0 + n - 1 of a (B*T, ld) input, columns 0 .. width - 1 of
// each (zero above, and zero steps past n), into dst; 16-byte pieces when
// vec (width and ld multiples of 4, src 16-byte aligned)
template <int N, int W>
__device__ __forceinline__ void stage_rows(float (&dst)[N][W],
                                           const float* src, int t0, int n,
                                           int ld, int width, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < N * W / 4; e += kThreads) {
      const int tt = e / (W / 4);
      const int i = 4 * (e - tt * (W / 4));
      const bool in = tt < n && i < width;
      cp16(&dst[tt][i], src + (in ? (size_t)(t0 + tt) * ld + i : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < N * W; e += kThreads) {
      const int tt = e / W;
      const int i = e - tt * W;
      const bool in = tt < n && i < width;
      cp4(&dst[tt][i], src + (in ? (size_t)(t0 + tt) * ld + i : 0), in);
    }
  }
}

// w, k (rows < dk) and v (the CTA's ncol columns) of steps t0 .. t0 + n - 1
template <int N>
__device__ __forceinline__ void stage_wkv(Inputs<N>& S, const float* w,
                                          const float* k, const float* v,
                                          int t0, int n, int dk, int dv,
                                          int ncol, bool vec) {
  stage_rows(S.w, w, t0, n, dk, dk, vec);
  stage_rows(S.k, k, t0, n, dk, dk, vec);
  stage_rows(S.v, v, t0, n, dv, ncol, vec);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

// S_t = diag(w_t) S_{t-1} + k_t^T v_t on the lane's tile
template <int N>
__device__ __forceinline__ void fwd_step(const Inputs<N>& S, int tt, int a,
                                         int cb, float (&s)[4][4]) {
  float ww[4], kk[4], vv[4];
  load4(&S.w[tt][4 * a], ww);
  load4(&S.k[tt][4 * a], kk);
  load4(&S.v[tt][cb], vv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[e][c] = fmaf(ww[e], s[e][c], kk[e] * vv[c]);
  }
}

// S_{t-1} of step tt into the lane's stash, then the step
__device__ __forceinline__ void stash_step(Smem& sm, const Stage& S, int tt,
                                           int tid, int a, int cb,
                                           float (&s)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sm.stash[tt][e][tid] = make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
  }
  fwd_step(S, tt, a, cb, s);
}

// Step tt of a chunk, backward, on the lane's tile: G and du's partial stay
// in registers; dv over the warp's 32 rows goes to sp, and dr, dk and dw
// over the CTA's 16 columns to rows
__device__ __forceinline__ void bwd_step(Smem& sm, const Stage& S,
                                         float (&rows)[kC][3][kDK], int tt,
                                         int tid, const float (&uu)[4],
                                         float (&g)[4][4],
                                         float (&du_acc)[4]) {
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int a = 8 * warp + (lane & 7);
  const int cb = 4 * (lane >> 3);
  float rr[4], ww[4], kk[4], vv[4], dd[4];
  load4(&S.r[tt][4 * a], rr);
  load4(&S.w[tt][4 * a], ww);
  load4(&S.k[tt][4 * a], kk);
  load4(&S.v[tt][cb], vv);
  load4(&S.dy[tt][cb], dd);
  float dot = 0.f;                        // this lane's part of dy . v
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) dot = fmaf(dd[cc], vv[cc], dot);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};    // dv, over this lane's rows
  float p[3][4];                          // dr, dk, dw of the lane's rows
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 q = sm.stash[tt][e][tid];
    const float sp[4] = {q.x, q.y, q.z, q.w};
    const float ru = rr[e] * uu[e];
    const float uk = uu[e] * kk[e];
    p[0][e] = p[1][e] = p[2][e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float gb = fmaf(ru, dd[cc], g[e][cc]);   // G + r u dy
      acc[cc] = fmaf(kk[e], gb, acc[cc]);
      p[1][e] = fmaf(vv[cc], gb, p[1][e]);
      p[0][e] = fmaf(dd[cc], fmaf(uk, vv[cc], sp[cc]), p[0][e]);
      p[2][e] = fmaf(g[e][cc], sp[cc], p[2][e]);
      g[e][cc] = fmaf(ww[e], g[e][cc], rr[e] * dd[cc]);
    }
    du_acc[e] = fmaf(rr[e] * kk[e], dot, du_acc[e]);
  }
  // dv: each column over the warp's 8 row groups (lane bits 0-2): xor 4
  // keeps columns {0,1} or {2,3}, xor 2 one of them, xor 1 adds the pair
  const bool b2 = lane & 4, b1 = lane & 2;
  float x0 = b2 ? acc[2] : acc[0];
  float x1 = b2 ? acc[3] : acc[1];
  x0 += __shfl_xor_sync(kAll, b2 ? acc[0] : acc[2], 4);
  x1 += __shfl_xor_sync(kAll, b2 ? acc[1] : acc[3], 4);
  float y = b1 ? x1 : x0;
  y += __shfl_xor_sync(kAll, b1 ? x0 : x1, 2);
  y += __shfl_xor_sync(kAll, y, 1);
  if ((lane & 1) == 0) sm.sp[tt][warp][cb + (b2 ? 2 : 0) + (b1 ? 1 : 0)] = y;
  // dr, dk, dw: each row over the 4 column groups (lane bits 3-4): xor 16
  // keeps rows {0,1} or {2,3}, xor 8 one of them (row 4a + 2 b4 + b3)
  const bool b4 = lane & 16, b3 = lane & 8;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float y0 = b4 ? p[q][2] : p[q][0];
    float y1 = b4 ? p[q][3] : p[q][1];
    y0 += __shfl_xor_sync(kAll, b4 ? p[q][0] : p[q][2], 16);
    y1 += __shfl_xor_sync(kAll, b4 ? p[q][1] : p[q][3], 16);
    float z = b3 ? y1 : y0;
    z += __shfl_xor_sync(kAll, b3 ? y0 : y1, 8);
    rows[tt][q][4 * a + (b4 ? 2 : 0) + (b3 ? 1 : 0)] = z;
  }
}

// The cluster's sum of one chunk's rows, split over its NCB x kThreads
// threads: element e = (tt * 3 + q) * kDK + i of rows (dr, dk or dw of row i
// at step tt), e = this thread's index in the cluster + j NCB kThreads.
// load() brings every rank's value of this thread's elements (all the
// loads in flight at once), store() adds them in rank order and writes the
// gradients; between the two the caller recomputes the next chunk's
// states.
template <int NCB>
struct ClusterSum {
  static constexpr int kE = (kC * 3 * kDK + NCB * kThreads - 1) /
                            (NCB * kThreads);
  float x[kE][NCB];

  __device__ __forceinline__ static bool valid(int e, int n, int dk) {
    return e < kC * 3 * kDK && e / (3 * kDK) < n && e % kDK < dk;
  }
  // every load is made (an index past the buffer reads its last element),
  // so that no predicate lives until store()
  __device__ __forceinline__ void load(const float (&rows)[kC][3][kDK],
                                       int rank) {
    const uint32_t local = smem_u32(&rows[0][0][0]);
    const int e0 = opaque(rank * kThreads + (int)threadIdx.x);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = min(e0 + j * NCB * kThreads, kC * 3 * kDK - 1);
#pragma unroll
      for (int src = 0; src < NCB; ++src) {
        x[j][src] = ld_cluster(map_rank(local + 4 * e, src));
      }
    }
  }
  __device__ __forceinline__ void store(int rank, int t0, int n, int dk,
                                        float* dr, float* dk_out, float* dw) {
    const int e0 = opaque(rank * kThreads + (int)threadIdx.x);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * NCB * kThreads;
      if (!valid(e, n, dk)) continue;
      const int tq = e / kDK;
      const int tt = tq / 3;
      const int q = tq - 3 * tt;
      float sum = x[j][0];
#pragma unroll
      for (int src = 1; src < NCB; ++src) sum += x[j][src];
      float* out = q == 0 ? dr : (q == 1 ? dk_out : dw);
      out[(size_t)(t0 + tt) * dk + e % kDK] = sum;
    }
  }
};

// NCB: the CTAs of a row, dv / 16 rounded up, = the cluster's size. Five
// CTAs share an SM (shared memory allows it, and the registers are held to
// it: 168 a thread, the 10 warps spread over the SM's 4 register files)
template <int NCB>
__global__ void __launch_bounds__(kThreads, 5)
ssm_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ w,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    const float* __restrict__ dy,
                    const float* __restrict__ ds_final,
                    float* __restrict__ dr, float* __restrict__ dw,
                    float* __restrict__ dk_out, float* __restrict__ dv_out,
                    float* __restrict__ ds0, float4* __restrict__ ckpt,
                    float* __restrict__ du_part, int T, int dk, int dv,
                    int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int a = 8 * warp + (lane & 7);      // rows 4a .. 4a+3
  const int cb = 4 * (lane >> 3);           // columns cb .. cb + 3
  const int rank = blockIdx.x % NCB;        // = %cluster_ctarank
  const size_t b = blockIdx.x / NCB;
  const int c0 = rank * kCols;
  const int ncol = min(kCols, dv - c0);
  const int nchunks = (T + kC - 1) / kC;
  r += b * (size_t)T * dk;
  w += b * (size_t)T * dk;
  k += b * (size_t)T * dk;
  v += b * (size_t)T * dv + c0;
  dy += b * (size_t)T * dv + c0;
  dv_out += b * (size_t)T * dv + c0;
  ckpt += (size_t)blockIdx.x * nchunks * 4 * kThreads;
  dr += b * (size_t)T * dk;
  dk_out += b * (size_t)T * dk;
  dw += b * (size_t)T * dk;
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

  // pass 1: the forward again in blocks of kP1 steps (the next block's w,
  // k, v landing meanwhile in the stash's space, unused until pass 2),
  // keeping the state at every chunk start
  const int nblocks = (T + kP1 - 1) / kP1;
  stage_wkv(sm.st1[0], w, k, v, 0, min(kP1, T), dk, dv, ncol, vec);
  cp_commit();
  for (int blk = 0; blk < nblocks; ++blk) {
    const int t0 = blk * kP1;
    const int n = min(kP1, T - t0);
    if (blk + 1 < nblocks) {
      stage_wkv(sm.st1[(blk + 1) & 1], w, k, v, t0 + kP1,
                min(kP1, T - t0 - kP1), dk, dv, ncol, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const Inputs<kP1>& S = sm.st1[blk & 1];
    for (int tc = 0; tc < n; tc += kC) {
      const size_t c = (size_t)(t0 + tc) / kC;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ckpt[(c * 4 + e) * kThreads + tid] =
            make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
      }
      if (n - tc >= kC) {
#pragma unroll
        for (int tt = 0; tt < kC; ++tt) fwd_step(S, tc + tt, a, cb, s);
      } else {
        for (int tt = tc; tt < n; ++tt) fwd_step(S, tt, a, cb, s);
      }
    }
    __syncthreads();   // this block's buffer is free for the block after next
  }

  // pass 2: the chunks from the last to the first
  auto stage2 = [&](Stage& S, int t0, int n) {
    stage_wkv(S, w, k, v, t0, n, dk, dv, ncol, vec);
    stage_rows(S.r, r, t0, n, dk, dk, vec);
    stage_rows(S.dy, dy, t0, n, dv, ncol, vec);
    cp_commit();
  };
  // A chunk's checkpoint lands in the lane's own stash slot kC - 1, which
  // the chunk after it has read by then (its first backward step) or not
  // used (a short last chunk): lane-private, so no barrier guards it.
  auto load_ckpt = [&](int c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cp16(reinterpret_cast<float*>(&sm.stash[kC - 1][e][tid]),
           reinterpret_cast<const float*>(&ckpt[((size_t)c * 4 + e) * kThreads + tid]),
           true);
    }
    cp_commit();
  };
  stage2(sm.st[(nchunks - 1) & 1], (nchunks - 1) * kC,
         T - (nchunks - 1) * kC);
  load_ckpt(nchunks - 1);
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, T - t0);
    if (c > 0) {
      stage2(sm.st[(c - 1) & 1], t0 - kC, kC);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 q = sm.stash[kC - 1][e][tid];
      s[e][0] = q.x;
      s[e][1] = q.y;
      s[e][2] = q.z;
      s[e][3] = q.w;
    }
    const Stage& S = sm.st[c & 1];
    // every rank has the rows of chunk c + 1 and is done reading those of
    // chunk c + 2, whose buffer this chunk's steps write: the loads of
    // chunk c + 1's sums fly while this chunk's states are recomputed
    // (there, unlike across the backward steps, registers are free)
    ClusterSum<NCB> sum;
    const bool pending = c < nchunks - 1;
    if (pending) {
      cluster_wait();
      sum.load(sm.rows[(c + 1) & 1], rank);
    }
    // S_{t-1} of each step into the stash
    if (n == kC) {
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) stash_step(sm, S, tt, tid, a, cb, s);
    } else {
      for (int tt = 0; tt < n; ++tt) stash_step(sm, S, tt, tid, a, cb, s);
    }
    if (pending) {
      sum.store(rank, t0 + kC, min(kC, T - t0 - kC), dk, dr, dk_out, dw);
    }
    float (&rows)[kC][3][kDK] = sm.rows[c & 1];
    if (n == kC) {
#pragma unroll
      for (int tt = kC - 1; tt >= 0; --tt) {
        bwd_step(sm, S, rows, tt, tid, uu, g, du_acc);
        if (tt == kC - 1 && c > 0) load_ckpt(c - 1);
      }
    } else {
      if (c > 0) load_ckpt(c - 1);
      for (int tt = n - 1; tt >= 0; --tt) {
        bwd_step(sm, S, rows, tt, tid, uu, g, du_acc);
      }
    }
    __syncthreads();   // sp complete, this stage read
    for (int e = tid; e < n * ncol; e += kThreads) {
      const int tt = e / ncol;
      const int cc = e - tt * ncol;
      dv_out[(size_t)(t0 + tt) * dv + cc] = sm.sp[tt][0][cc] + sm.sp[tt][1][cc];
    }
    cluster_arrive();  // this chunk's rows are complete
  }
  cluster_wait();
  {
    ClusterSum<NCB> sum;
    sum.load(sm.rows[0], rank);
    sum.store(rank, 0, min(kC, T), dk, dr, dk_out, dw);
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
  // du of this CTA per row (the 4 column groups: xor 16, 8) into the free
  // rows buffer; then rank 0 adds the ranks in order
  float* du_row = &sm.rows[1][0][0][0];
  if (du_part != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      du_acc[e] += __shfl_xor_sync(kAll, du_acc[e], 16);
      du_acc[e] += __shfl_xor_sync(kAll, du_acc[e], 8);
      if ((lane >> 3) == 0) du_row[4 * a + e] = du_acc[e];
    }
  }
  cluster_arrive();    // done reading chunk 0's rows; du's partials written
  cluster_wait();
  if (du_part != nullptr) {
    if (rank == 0) {
      for (int i = tid; i < dk; i += kThreads) {
        float sum = du_row[i];
        for (int rk = 1; rk < NCB; ++rk) {
          sum += ld_cluster(map_rank(smem_u32(&du_row[i]), rk));
        }
        du_part[b * dk + i] = sum;
      }
    }
    cluster_arrive();  // no CTA leaves while rank 0 reads its du
    cluster_wait();
  }
}

// du (dk,): the per-row partials added in row order
__global__ void ssm_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int rows, int dk) {
  for (int i = threadIdx.x; i < dk; i += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < rows; ++c) acc += du_part[(size_t)c * dk + i];
    du[i] = acc;
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                       const float*, const float*, const float*,
                       const float*, const float*, float*, float*, float*,
                       float*, float*, float4*, float*, int, int, int, int);

// the instantiation for a cluster of ncb CTAs, with its attributes set
cudaError_t kernel_for(int ncb, Kernel* kern) {
  static const Kernel kernels[kMaxCluster] = {
      ssm_scan_bwd_kernel<1>, ssm_scan_bwd_kernel<2>, ssm_scan_bwd_kernel<3>,
      ssm_scan_bwd_kernel<4>, ssm_scan_bwd_kernel<5>, ssm_scan_bwd_kernel<6>,
      ssm_scan_bwd_kernel<7>, ssm_scan_bwd_kernel<8>};
  *kern = kernels[ncb - 1];
  cudaError_t err = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// the cluster launch: B * ncb CTAs of kThreads, clusters of ncb
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int B, int ncb, cudaStream_t st) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ncb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(B * ncb), 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = sizeof(Smem);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

// r, w, k (B, T, dk), v and dy (B, T, dv), fp32 contiguous; u (dk), s0 and
// ds_final (B, dk, dv) or null. Writes dr, dw, dk (B, T, dk), dv (B, T,
// dv), du (dk) when u is given and ds0 (B, dk, dv) when s0 is given.
// Scratch from the caller, fp32: ckpt of B * ceil(dv / 16) * ceil(T / 6) *
// 1,024 floats (16-byte aligned), du_part of B * dk (null without u).
extern "C" int ssm_scan_bwd_launch(
    const void* r, const void* w, const void* k, const void* v,
    const void* u, const void* s0, const void* dy, const void* ds_final,
    void* dr, void* dw, void* dk_out, void* dv_out, void* du, void* ds0,
    void* ckpt, void* du_part, int B, int T, int dk, int dv, int device,
    void* stream) {
  if (B < 1 || T < 1 || dk < 1 || dk > kDK || dv < 1 || dv > kDVMax ||
      dy == nullptr || (u != nullptr) != (du != nullptr) ||
      (u != nullptr) != (du_part != nullptr) ||
      (s0 != nullptr) != (ds0 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ncb = (dv + kCols - 1) / kCols;
  Kernel kern;
  err = kernel_for(ncb, &kern);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)r | (uintptr_t)w | (uintptr_t)k |
                         (uintptr_t)v | (uintptr_t)dy;
  const int vec = dk % 4 == 0 && dv % 4 == 0 && ptrs % 16 == 0;
  Launch L(B, ncb, st);
  err = cudaLaunchKernelEx(
      &L.cfg, kern, (const float*)r, (const float*)w,
      (const float*)k, (const float*)v, (const float*)u, (const float*)s0,
      (const float*)dy, (const float*)ds_final, (float*)dr, (float*)dw,
      (float*)dk_out, (float*)dv_out, (float*)ds0, (float4*)ckpt,
      (float*)du_part, T, dk, dv, vec);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (u != nullptr) {
    ssm_bwd_du_kernel<<<1, 64, 0, st>>>((const float*)du_part, (float*)du, B,
                                        dk);
    err = cudaGetLastError();
  }
  return (int)err;
}

// What the launch of ssm_scan_bwd_launch at (B, dv) gets: the clusters of
// the kernel the device holds at once (cudaOccupancyMaxActiveClusters),
// the cluster size, and the shared memory of a CTA in bytes.
extern "C" int ssm_scan_bwd_occupancy(int B, int dv, int device,
                                      int* clusters, int* cluster_size,
                                      int* smem_bytes) {
  if (B < 1 || dv < 1 || dv > kDVMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ncb = (dv + kCols - 1) / kCols;
  Kernel kern;
  err = kernel_for(ncb, &kern);
  if (err != cudaSuccess) return (int)err;
  Launch L(B, ncb, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kern, &L.cfg);
  *cluster_size = ncb;
  *smem_bytes = (int)sizeof(Smem);
  return (int)err;
}
