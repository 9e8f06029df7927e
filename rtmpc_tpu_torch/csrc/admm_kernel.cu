// Fused batched OSQP-ADMM solve for the canonical MPC box-QP, for Hopper (sm_90a).
//
// Replaces: rtmpc_tpu/ops/qp_pallas.py:_admm_kernel, the Pallas TPU kernel that
// admm_solve_pallas launches once per phase of the two-phase rho schedule
// (rtmpc_tpu/parallel/rollout.py:396-406).  Same function, per batch row:
//   q, l, u = q0 + Mq th, l0 + Ml th, u0 + Mu th        (th = theta row)
//   qcat    = q Kcat                                     (hoisted out of the loop)
//   iters x:  [xt | zt] = [x | rho z - y] [Gxc; Gsc] - qcat
//             x <- a xt + (1-a) x;   zm = a zt + (1-a) z
//             z <- clip(zm + y / rho, l, u);   y <- y + rho (zm - z)
//   r_prim = max |As x - z|,   r_dual = max |Ps x + q + As' y|
// The caller unscales the primal (z_primal = D x).  The composites are the
// compact (n+m)-wide [x | z] layout, not the TPU's 128-lane output slots.
//
// What bounds it on the H100: FP32 FMA issue and shared-memory reads.  One
// iteration is a (1 x nm) by (nm x nm) product per row, nm = n + m = 152 on
// the flagship: about 46k flops per row per iteration, 5.5 Mflop per row per
// 60-iteration phase.  Device-memory traffic is only the per-row state, read
// and written once per launch (~2 KB a row), so the kernel sits far on the
// compute side of the card's roofline.
//
// What the design does about it:
//  * [Gxc; Gsc] (nm x nm f32, 92,416 B on the flagship) is loaded once per
//    block into dynamic shared memory and stays there for the whole loop.
//  * One block owns kRows = 16 batch rows; thread j owns output column j for
//    all 16 rows, so each shared-memory read of a G element feeds 16 FMAs.
//    The iterate [x | s] sits in shared memory transposed (column k holds the
//    16 rows' values), read as four broadcast float4 loads per k.
//  * Thread j also owns the per-row state of its column in registers (x_j, or
//    y_i, z_i, l_i, u_i with i = j - n) and applies the elementwise update
//    itself, so the only traffic between threads is the iterate in shared
//    memory, fenced by two __syncthreads() per iteration.
//  * The ragged batch tail is masked (rows >= B read zeros and write
//    nothing); nothing is padded on the host.
//  * Residuals are computed in the kernel from As and Ps read from global
//    memory (once per launch), reduced per row with shared-memory atomics.
// Shared memory is ~108 KB a block on the flagship, so two blocks share an SM.
//
// Large composites (n + m > 192; up to 2048): admm_kernel_l2 below, the same
// function for QPs whose [Gxc; Gsc] does not fit in shared memory.  The
// cartpole tube and tracking QPs have n + m = 904 and 952: 3.3 and 3.6 MB of
// f32, against 227 KB of shared memory a block and 50 MB of L2.
//
// What bounds it: L2 reads of G.  Every iteration each block streams all of
// [Gxc; Gsc] (4 (n+m)^2 bytes) from L2 once, and each G element it reads
// feeds kRowsL = 4 FMAs, so the traffic is (B / 4) * 4 (n+m)^2 bytes an
// iteration: 180 MB at B=200 on the tracking QP, about 36 GB for a
// 200-iteration phase.  The FMA work (2 B (n+m)^2 flops an iteration) is
// small beside it.
//
// What the design does about it:
//  * G stays in device memory, where it is L2-resident across iterations and
//    blocks.  Thread t owns output columns t, t + 512, ... (C <= 4 of them);
//    a warp's read of G[k, j..j+31] is one coalesced 128-byte line, and the
//    k loop is unrolled so several lines are in flight per thread.
//  * One block owns kRowsL = 4 batch rows (50 blocks at B=200), so each G
//    element is read once per 4 rows and enough SMs pull from L2 at once.
//    The iterate [x | rho z - y] of the 4 rows sits in shared memory as one
//    float4 per column, read as a broadcast.
//  * The 904- and 952-term dot products are summed in blocks of 32 terms
//    (gemv_rows): one FMA chain over all of them was measured 4-10x
//    further from the float64 result than cuBLAS's float32 product.
//  * As in the small path, thread t keeps the per-row state of its columns
//    in registers and applies the elementwise update itself, with two
//    __syncthreads() per iteration; the ragged tail is masked; the
//    residuals are reduced with shared-memory atomics.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;         // batch rows per block
constexpr int kStride = 20;       // floats between columns of a transposed buffer:
                                  // keeps float4 alignment, no store bank conflicts
constexpr int kMaxThreads = 192;  // one thread per output column: n + m <= 192

constexpr int kRowsL = 4;         // batch rows per block, large path
constexpr int kThreadsL = 512;    // threads per block, large path
constexpr int kMaxColsL = 4;      // output columns per thread: n + m <= 2048
constexpr int kBlockL = 32;       // terms per partial sum of a long dot product

// jnp.clip semantics: maximum then minimum, and a NaN stays NaN
// (fmaxf/fminf would replace it by a bound and hide a diverged iterate).
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  const float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

__device__ __forceinline__ void fma_rows(float (&acc)[kRows], const float* col,
                                         float g) {
  const float4* c4 = reinterpret_cast<const float4*>(col);
#pragma unroll
  for (int c = 0; c < kRows / 4; ++c) {
    const float4 v = c4[c];
    acc[4 * c + 0] = fmaf(v.x, g, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(v.y, g, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(v.z, g, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(v.w, g, acc[4 * c + 3]);
  }
}

__device__ __forceinline__ void store_rows(float* col, const float (&v)[kRows]) {
  float4* c4 = reinterpret_cast<float4*>(col);
#pragma unroll
  for (int c = 0; c < kRows / 4; ++c)
    c4[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

__global__ void __launch_bounds__(kMaxThreads, 2)
admm_kernel(const float* __restrict__ theta,
            const float* __restrict__ x_in, const float* __restrict__ y_in,
            const float* __restrict__ z_in,
            const float* __restrict__ Gxc, const float* __restrict__ Gsc,
            const float* __restrict__ Kcat,
            const float* __restrict__ As, const float* __restrict__ Ps,
            const float* __restrict__ Mq, const float* __restrict__ Ml,
            const float* __restrict__ Mu,
            const float* __restrict__ q0, const float* __restrict__ l0,
            const float* __restrict__ u0,
            const float* __restrict__ rho, const float* __restrict__ rho_inv,
            const float* __restrict__ alpha_p,
            float* __restrict__ x_out, float* __restrict__ y_out,
            float* __restrict__ z_out,
            float* __restrict__ r_prim, float* __restrict__ r_dual,
            int B, int n, int m, int nt, int iters) {
  extern __shared__ __align__(16) float smem[];
  const int nm = n + m;
  float* V = smem;                   // (nm, kStride): [x | rho z - y], transposed
  float* Qs = V + nm * kStride;      // (n, kStride): q, transposed
  float* G = Qs + n * kStride;       // (nm, nm): [Gxc; Gsc]; after the loop, y
  __shared__ int rp_bits[kRows];     // non-negative floats order like their bits
  __shared__ int rd_bits[kRows];

  const int j = threadIdx.x;
  const bool is_x = j < n;
  const bool is_c = j >= n && j < nm;
  const int i = j - n;               // constraint row of a constraint column
  const int jc = j < nm ? j : nm - 1;  // idle lanes read a valid column
  const int row0 = blockIdx.x * kRows;
  const float alpha = *alpha_p;

  for (int e = j; e < n * nm; e += blockDim.x) G[e] = Gxc[e];
  for (int e = j; e < m * nm; e += blockDim.x) G[n * nm + e] = Gsc[e];
  if (j < kRows) {
    rp_bits[j] = 0;
    rd_bits[j] = 0;
  }

  float a[kRows];    // x_j (x column) or y_i (constraint column)
  float b[kRows];    // z_i
  float lo[kRows];   // l_i
  float hi[kRows];   // u_i
  const float rho_i = is_c ? rho[i] : 0.f;
  const float rinv_i = is_c ? rho_inv[i] : 0.f;

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    const bool valid = row < B;
    const float* th = theta + (size_t)row * nt;
    a[r] = b[r] = lo[r] = hi[r] = 0.f;
    if (is_x) {
      float s = 0.f;
      for (int t = 0; t < nt; ++t) s = fmaf(Mq[j * nt + t], valid ? th[t] : 0.f, s);
      Qs[j * kStride + r] = q0[j] + s;
      a[r] = valid ? x_in[(size_t)row * n + j] : 0.f;
    } else if (is_c) {
      float sl = 0.f, su = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float tv = valid ? th[t] : 0.f;
        sl = fmaf(Ml[i * nt + t], tv, sl);
        su = fmaf(Mu[i * nt + t], tv, su);
      }
      lo[r] = l0[i] + sl;
      hi[r] = u0[i] + su;
      a[r] = valid ? y_in[(size_t)row * m + i] : 0.f;
      b[r] = valid ? z_in[(size_t)row * m + i] : 0.f;
    }
  }
  {
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = is_x ? a[r] : rho_i * b[r] - a[r];
    if (j < nm) store_rows(V + j * kStride, v);
  }
  __syncthreads();

  // hoisted linear term: qc = q Kcat (column j), Kcat read once from global
  float qc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) qc[r] = 0.f;
  for (int k = 0; k < n; ++k) fma_rows(qc, Qs + k * kStride, Kcat[k * nm + jc]);

  for (int it = 0; it < iters; ++it) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < nm; ++k) fma_rows(acc, V + k * kStride, G[k * nm + jc]);
    __syncthreads();  // every read of V is done before it is overwritten
    float v[kRows];
    if (is_x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a[r] = alpha * (acc[r] - qc[r]) + (1.f - alpha) * a[r];
        v[r] = a[r];
      }
      store_rows(V + j * kStride, v);
    } else if (is_c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float zm = alpha * (acc[r] - qc[r]) + (1.f - alpha) * b[r];
        const float zn = clip_nan(zm + a[r] * rinv_i, lo[r], hi[r]);
        a[r] = a[r] + rho_i * (zm - zn);
        b[r] = zn;
        v[r] = rho_i * zn - a[r];
      }
      store_rows(V + j * kStride, v);
    }
    __syncthreads();  // the new iterate is complete before the next product
  }

  // final iterate out; y, transposed, into the G buffer (no longer read)
  float* Ys = G;
  if (is_c) store_rows(Ys + i * kStride, a);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= B) continue;
    if (is_x) x_out[(size_t)row * n + j] = a[r];
    if (is_c) {
      y_out[(size_t)row * m + i] = a[r];
      z_out[(size_t)row * m + i] = b[r];
    }
  }
  __syncthreads();  // Ys complete (G was last read before the loop's fences)

  float res[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) res[r] = 0.f;
  if (is_c) {
    // primal residual row i: As[i, :] x - z_i
    for (int k = 0; k < n; ++k) fma_rows(res, V + k * kStride, As[(size_t)i * n + k]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < B) atomicMax(&rp_bits[r], __float_as_int(fabsf(res[r] - b[r])));
  } else if (is_x) {
    // dual residual entry j: Ps[j, :] x + q_j + As[:, j]' y
    for (int k = 0; k < n; ++k) fma_rows(res, V + k * kStride, Ps[(size_t)j * n + k]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) res[r] += Qs[j * kStride + r];
    for (int k = 0; k < m; ++k) fma_rows(res, Ys + k * kStride, As[(size_t)k * n + j]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < B) atomicMax(&rd_bits[r], __float_as_int(fabsf(res[r])));
  }
  __syncthreads();
  if (j < kRows && row0 + j < B) {
    r_prim[row0 + j] = __int_as_float(rp_bits[j]);
    r_dual[row0 + j] = __int_as_float(rd_bits[j]);
  }
}

__device__ __forceinline__ void fma4(float (&acc)[kRowsL], const float4 v, float g) {
  acc[0] = fmaf(v.x, g, acc[0]);
  acc[1] = fmaf(v.y, g, acc[1]);
  acc[2] = fmaf(v.z, g, acc[2]);
  acc[3] = fmaf(v.w, g, acc[3]);
}

__device__ __forceinline__ float4 as_float4(const float (&v)[kRowsL]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// acc[c][r] += sum_k V[k].r * G[k, jc[c]] over k < len, in blocks of kBlockL
// terms whose partial sums are added to acc: the rounding error grows with
// the block length plus the block count, not with len (952 on the cartpole
// tracking QP).
template <int C>
__device__ __forceinline__ void gemv_rows(float (&acc)[C][kRowsL],
                                          const float4* __restrict__ V,
                                          const float* __restrict__ G, int len,
                                          int ld, const int (&jc)[C]) {
  for (int k0 = 0; k0 < len; k0 += kBlockL) {
    float part[C][kRowsL];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) part[c][r] = 0.f;
    const int k1 = min(k0 + kBlockL, len);
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float4 v = V[k];
      const float* g = G + (size_t)k * ld;
#pragma unroll
      for (int c = 0; c < C; ++c) fma4(part[c], v, __ldg(g + jc[c]));
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) acc[c][r] += part[c][r];
  }
}

// The large-composite path: the same function as admm_kernel, for
// n + m <= C * kThreadsL, with [Gxc; Gsc] read from device memory (L2).
template <int C>
__global__ void __launch_bounds__(kThreadsL)
admm_kernel_l2(const float* __restrict__ theta,
               const float* __restrict__ x_in, const float* __restrict__ y_in,
               const float* __restrict__ z_in,
               const float* __restrict__ Gxc, const float* __restrict__ Gsc,
               const float* __restrict__ Kcat,
               const float* __restrict__ As, const float* __restrict__ Ps,
               const float* __restrict__ Mq, const float* __restrict__ Ml,
               const float* __restrict__ Mu,
               const float* __restrict__ q0, const float* __restrict__ l0,
               const float* __restrict__ u0,
               const float* __restrict__ rho, const float* __restrict__ rho_inv,
               const float* __restrict__ alpha_p,
               float* __restrict__ x_out, float* __restrict__ y_out,
               float* __restrict__ z_out,
               float* __restrict__ r_prim, float* __restrict__ r_dual,
               int B, int n, int m, int nt, int iters) {
  extern __shared__ __align__(16) float smem[];
  const int nm = n + m;
  float4* V = reinterpret_cast<float4*>(smem);  // (nm): [x | rho z - y] of the 4 rows
  float4* Qs = V + nm;                          // (n): q of the 4 rows
  float4* Ys = Qs + n;                          // (m): y after the loop
  __shared__ int rp_bits[kRowsL];               // non-negative floats order like their bits
  __shared__ int rd_bits[kRowsL];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRowsL;
  const float alpha = *alpha_p;
  if (t < kRowsL) {
    rp_bits[t] = 0;
    rd_bits[t] = 0;
  }

  float a[C][kRowsL];   // x_j (x column) or y_i (constraint column)
  float b[C][kRowsL];   // z_i
  float lo[C][kRowsL];  // l_i
  float hi[C][kRowsL];  // u_i
  float rho_c[C], rinv_c[C];
  int jc[C];            // owned column, clamped so idle columns read valid memory

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t + c * kThreadsL;
    const bool is_x = j < n;
    const bool is_c = j >= n && j < nm;
    const int i = j - n;
    jc[c] = j < nm ? j : nm - 1;
    rho_c[c] = is_c ? rho[i] : 0.f;
    rinv_c[c] = is_c ? rho_inv[i] : 0.f;
    float q[kRowsL];
#pragma unroll
    for (int r = 0; r < kRowsL; ++r) {
      const int row = row0 + r;
      const bool valid = row < B;
      const float* th = theta + (size_t)row * nt;
      a[c][r] = b[c][r] = lo[c][r] = hi[c][r] = q[r] = 0.f;
      if (is_x) {
        float s = 0.f;
        for (int e = 0; e < nt; ++e) s = fmaf(Mq[j * nt + e], valid ? th[e] : 0.f, s);
        q[r] = q0[j] + s;
        a[c][r] = valid ? x_in[(size_t)row * n + j] : 0.f;
      } else if (is_c) {
        float sl = 0.f, su = 0.f;
        for (int e = 0; e < nt; ++e) {
          const float tv = valid ? th[e] : 0.f;
          sl = fmaf(Ml[i * nt + e], tv, sl);
          su = fmaf(Mu[i * nt + e], tv, su);
        }
        lo[c][r] = l0[i] + sl;
        hi[c][r] = u0[i] + su;
        a[c][r] = valid ? y_in[(size_t)row * m + i] : 0.f;
        b[c][r] = valid ? z_in[(size_t)row * m + i] : 0.f;
      }
    }
    if (is_x) {
      Qs[j] = as_float4(q);
      V[j] = as_float4(a[c]);
    } else if (is_c) {
      float v[kRowsL];
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) v[r] = rho_c[c] * b[c][r] - a[c][r];
      V[j] = as_float4(v);
    }
  }
  __syncthreads();

  // hoisted linear term: qc = q Kcat (owned columns), Kcat read once
  float qc[C][kRowsL];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < kRowsL; ++r) qc[c][r] = 0.f;
  gemv_rows<C>(qc, Qs, Kcat, n, nm, jc);

  for (int it = 0; it < iters; ++it) {
    float acc[C][kRowsL];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) acc[c][r] = 0.f;
    gemv_rows<C>(acc, V, Gxc, n, nm, jc);
    gemv_rows<C>(acc, V + n, Gsc, m, nm, jc);
    __syncthreads();  // every read of V is done before it is overwritten
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = t + c * kThreadsL;
      float v[kRowsL];
      if (j < n) {
#pragma unroll
        for (int r = 0; r < kRowsL; ++r) {
          a[c][r] = alpha * (acc[c][r] - qc[c][r]) + (1.f - alpha) * a[c][r];
          v[r] = a[c][r];
        }
        V[j] = as_float4(v);
      } else if (j < nm) {
#pragma unroll
        for (int r = 0; r < kRowsL; ++r) {
          const float zm = alpha * (acc[c][r] - qc[c][r]) + (1.f - alpha) * b[c][r];
          const float zn = clip_nan(zm + a[c][r] * rinv_c[c], lo[c][r], hi[c][r]);
          a[c][r] = a[c][r] + rho_c[c] * (zm - zn);
          b[c][r] = zn;
          v[r] = rho_c[c] * zn - a[c][r];
        }
        V[j] = as_float4(v);
      }
    }
    __syncthreads();  // the new iterate is complete before the next product
  }

  // final iterate out; y into Ys for the dual residual (V keeps x)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t + c * kThreadsL;
    const int i = j - n;
    if (j >= n && j < nm) Ys[i] = as_float4(a[c]);
#pragma unroll
    for (int r = 0; r < kRowsL; ++r) {
      const int row = row0 + r;
      if (row >= B) continue;
      if (j < n) x_out[(size_t)row * n + j] = a[c][r];
      else if (j < nm) {
        y_out[(size_t)row * m + i] = a[c][r];
        z_out[(size_t)row * m + i] = b[c][r];
      }
    }
  }
  __syncthreads();  // Ys complete

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t + c * kThreadsL;
    const int i = j - n;
    float res[kRowsL] = {0.f, 0.f, 0.f, 0.f};
    if (j >= n && j < nm) {
      // primal residual row i: As[i, :] x - z_i
      for (int k = 0; k < n; ++k) fma4(res, V[k], As[(size_t)i * n + k]);
#pragma unroll
      for (int r = 0; r < kRowsL; ++r)
        if (row0 + r < B)
          atomicMax(&rp_bits[r], __float_as_int(fabsf(res[r] - b[c][r])));
    } else if (j < n) {
      // dual residual entry j: Ps[j, :] x + q_j + As[:, j]' y
      for (int k = 0; k < n; ++k) fma4(res, V[k], Ps[(size_t)j * n + k]);
      const float4 qv = Qs[j];
      res[0] += qv.x;
      res[1] += qv.y;
      res[2] += qv.z;
      res[3] += qv.w;
      for (int k0 = 0; k0 < m; k0 += kBlockL) {
        float part[kRowsL] = {0.f, 0.f, 0.f, 0.f};
        const int k1 = min(k0 + kBlockL, m);
        for (int k = k0; k < k1; ++k) fma4(part, Ys[k], As[(size_t)k * n + j]);
#pragma unroll
        for (int r = 0; r < kRowsL; ++r) res[r] += part[r];
      }
#pragma unroll
      for (int r = 0; r < kRowsL; ++r)
        if (row0 + r < B) atomicMax(&rd_bits[r], __float_as_int(fabsf(res[r])));
    }
  }
  __syncthreads();
  if (t < kRowsL && row0 + t < B) {
    r_prim[row0 + t] = __int_as_float(rp_bits[t]);
    r_dual[row0 + t] = __int_as_float(rd_bits[t]);
  }
}

template <int C>
cudaError_t launch_l2(const float* theta, const float* x_in, const float* y_in,
                      const float* z_in, const float* Gxc, const float* Gsc,
                      const float* Kcat, const float* As, const float* Ps,
                      const float* Mq, const float* Ml, const float* Mu,
                      const float* q0, const float* l0, const float* u0,
                      const float* rho, const float* rho_inv, const float* alpha,
                      float* x_out, float* y_out, float* z_out, float* r_prim,
                      float* r_dual, int B, int n, int m, int nt, int iters,
                      cudaStream_t stream) {
  const size_t smem = (size_t)2 * (n + m) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel_l2<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((B + kRowsL - 1) / kRowsL));
  admm_kernel_l2<C><<<grid, kThreadsL, smem, stream>>>(
      theta, x_in, y_in, z_in, Gxc, Gsc, Kcat, As, Ps, Mq, Ml, Mu, q0, l0, u0,
      rho, rho_inv, alpha, x_out, y_out, z_out, r_prim, r_dual, B, n, m, nt, iters);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one solve of `iters`
// iterations for B rows on `stream` and returns cudaGetLastError() of the
// launch (0 on success); a refused launch never runs, so the caller must check.
// n + m <= 192 runs admm_kernel (G in shared memory), n + m <= 2048
// admm_kernel_l2 (G in L2); a larger QP is refused.
extern "C" int rtmpc_admm_solve_f32(
    const float* theta, const float* x_in, const float* y_in, const float* z_in,
    const float* Gxc, const float* Gsc, const float* Kcat,
    const float* As, const float* Ps,
    const float* Mq, const float* Ml, const float* Mu,
    const float* q0, const float* l0, const float* u0,
    const float* rho, const float* rho_inv, const float* alpha,
    float* x_out, float* y_out, float* z_out, float* r_prim, float* r_dual,
    int B, int n, int m, int nt, int iters, int device, void* stream) {
  const int nm = n + m;
  const int threads = ((nm + 31) / 32) * 32;
  if (B <= 0 || n <= 0 || m <= 0 || nt < 0 || iters < 0 ||
      nm > kThreadsL * kMaxColsL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads > kMaxThreads) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch ((nm + kThreadsL - 1) / kThreadsL) {
#define RTMPC_L2(C)                                                             \
  case C:                                                                      \
    return (int)launch_l2<C>(theta, x_in, y_in, z_in, Gxc, Gsc, Kcat, As, Ps,  \
                             Mq, Ml, Mu, q0, l0, u0, rho, rho_inv, alpha,      \
                             x_out, y_out, z_out, r_prim, r_dual, B, n, m, nt, \
                             iters, s);
      RTMPC_L2(1)
      RTMPC_L2(2)
      RTMPC_L2(3)
      RTMPC_L2(4)
#undef RTMPC_L2
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int g_floats = nm * nm > m * kStride ? nm * nm : m * kStride;
  const size_t smem = (size_t)(nm * kStride + n * kStride + g_floats) * sizeof(float);
  err = cudaFuncSetAttribute(admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + kRows - 1) / kRows));
  admm_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      theta, x_in, y_in, z_in, Gxc, Gsc, Kcat, As, Ps, Mq, Ml, Mu, q0, l0, u0,
      rho, rho_inv, alpha, x_out, y_out, z_out, r_prim, r_dual, B, n, m, nt, iters);
  return (int)cudaGetLastError();
}
