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

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;         // batch rows per block
constexpr int kStride = 20;       // floats between columns of a transposed buffer:
                                  // keeps float4 alignment, no store bank conflicts
constexpr int kMaxThreads = 192;  // one thread per output column: n + m <= 192

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

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one solve of `iters`
// iterations for B rows on `stream` and returns cudaGetLastError() of the
// launch (0 on success); a refused launch never runs, so the caller must check.
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
  if (B <= 0 || n <= 0 || m <= 0 || nt < 0 || iters < 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
