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
// One iteration is a (rows x nm) by (nm x nm) FP32 product, nm = n + m, with
// a nonlinear elementwise update between products, so the iterations are
// sequential and the product is the work: 2 nm^2 flops a row an iteration
// against a few KB of device memory a row a launch.  Both paths are bound by
// FP32 FMA issue (no tensor cores: the product stays FP32 FFMA with FP32
// accumulation); the designs differ in where [Gxc; Gsc] lives.
//
// The composite form is a choice: the factored form xt = (sigma x - q +
// (rho z - y) As) Kinv', zt = xt As' needs 2 (n^2 + 2 n m) flops a row an
// iteration, 2.2x fewer on the flagship and 4.3-4.5x fewer on the cartpole
// QPs, but it is three dependent products an iteration (three barriers, or
// three exchanges across a cluster) where this is one.  The FP32 bound that
// ops/kernel_bench.py states counts the factored form's operations, so these
// kernels cannot reach it as they are built.
//
// Small composites (nm <= 192, the flagship's 40 + 112): admm_kernel<RG>,
// register-tiled, G in shared memory.
//  * A block owns R = 8 RG batch rows (64, or 32 where 64 do not fit) and
//    copies G (nm x nm f32, 92,416 B on the flagship) once into dynamic shared
//    memory with 16-byte asynchronous copies (cp.async) that run while the
//    block reads its state; G stays there for the whole loop.  One block runs
//    on an SM.
//  * A thread owns a tile of 8 rows x 4 columns and accumulates it in
//    registers: a k step loads 8 iterate values (two 16-byte loads) and 4 G
//    values (one 16-byte load) and issues 32 FMAs, 3 shared-memory
//    instructions per 32 FMAs, with the loads of step k + 1 issued before the
//    FMAs of step k.  A warp is 4 row groups x 8 column groups, so the G load
//    of a k step is one 128-byte line and the iterate loads are 4 distinct
//    16-byte words on distinct banks.
//  * The iterate [x | rho z - y] sits in shared memory k-major (the R rows of
//    one column contiguous, row stride R + 4 floats) with its columns
//    permuted: column j = 4 cg + c sits at position c ncg + cg, and G's rows
//    are stored in the same order.  The product does not care about the
//    order of k, and with it the 8 column groups of a warp store their tiles
//    to banks 16 bytes apart instead of all to the same banks.
//  * The thread that owns a tile also owns its state and applies the
//    elementwise update on its accumulators: x or y, and q Kcat, stay in
//    registers; l and u (read once an iteration) sit in shared memory in the
//    permuted order, and so does z at 64 rows a block: the flagship's 10
//    warps put 3 on one scheduler, which leaves a thread 168 registers, and
//    with z in them too the product's loads could not run ahead.  Two
//    __syncthreads() an iteration fence the iterate.
//  * q Kcat and the residuals run through the same tile product, with Kcat,
//    then [Ps' | As'] and As, staged in G's buffer before and after the loop.
//
// Large composites (192 < nm <= 2048; the cartpole tube and tracking QPs
// have nm = 904 and 952, 3.3 and 3.6 MB of G): admm_kernel_cluster<RC, NH>,
// the columns split over a thread-block cluster, G streamed from L2.
//  * A cluster of 8 blocks owns RC batch rows (16; 8 above 1024 columns).
//    Block c of the cluster computes columns [c w, (c+1) w) of [xt | zt] for
//    all of the cluster's rows, w = nm / 8 rounded up to a multiple of 4, and
//    owns the state of those columns.  So a block streams only its column
//    slice of G an iteration (453 KB on the tracking QP) and every G element
//    it reads feeds RC FMAs: the L2 traffic is (B / RC) 4 nm^2 bytes an
//    iteration, 47 MB at B=200 on the tracking QP.
//  * Inside a block (8 warps), a warp takes a slice of k (nm / 8 terms) and a
//    lane 4 columns: the lane reads G[k, 4 columns] straight from L2 as one
//    16-byte load (a warp reads one contiguous row segment), 4 rows of G
//    ahead of the FMAs, and holds an RC x 4 tile in registers: 64 FMAs on 1
//    global and 4 broadcast shared-memory loads.  The 8 warps' partial tiles
//    go to shared memory and are summed by the owner threads, and a warp
//    flushes its tile there every 64 terms, so a dot product is a sum of
//    chains of at most 64 terms, not one long chain.
//  * An owner thread holds 8 rows of one column: x or (y, z), and q Kcat, in
//    registers, l and u in shared memory.  It applies the update to the
//    summed partials and writes the new value into the block's own copy of
//    the next iterate.
//  * The iterate is kept twice.  After its update a block sends its slice of
//    the next iterate (contiguous in the k-major buffer) to the 7 other
//    blocks as one bulk copy each through distributed shared memory
//    (cp.async.bulk.shared::cluster), completing on the receiver's mbarrier,
//    and waits on its own mbarrier for the 7 slices it is sent: one
//    __syncthreads() and one mbarrier wait an iteration, no cluster-wide
//    barrier in the loop.  (Storing each value into the 8 copies with
//    ordinary remote stores between two cluster.sync() cost 0.6 ms more a
//    200-iteration phase on an NVIDIA H100 80GB HBM3 at 700 W.)
//  * After the loop [x | y] is exchanged the same way, the owners compute
//    the residuals of their columns, and the cluster's maxima are reduced
//    into the first block's shared memory with atomics.
// Both paths mask the ragged batch tail (rows >= B read zeros and write
// nothing); nothing is padded on the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 8;      // rows of a thread's register tile, small path
constexpr int kTileCols = 4;      // and its columns
constexpr int kMaxColsSmall = 192;
constexpr int kMaxThreadsSmall = 320;  // 2 row halves x 5 column chunks of a warp
constexpr size_t kSmemLimit = 232448 - 1024;  // opt-in maximum less the static part

constexpr int kCluster = 8;       // blocks a cluster (the portable maximum)
constexpr int kThreadsC = 256;    // threads a block, large path
constexpr int kWarpsC = kThreadsC / 32;
constexpr int kPrefetch = 4;      // rows of G a lane keeps in flight from L2
constexpr int kChunk = 64;        // terms per FMA chain before a flush
constexpr int kBlockL = 32;       // terms per partial sum of the residuals' long sums
constexpr int kMaxColsLarge = 2048;

// jnp.clip semantics: maximum then minimum, and a NaN stays NaN
// (fmaxf/fminf would replace it by a bound and hide a diverged iterate).
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  const float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

// v0[idx] + M[idx, :] th, with th read as zeros for a row past the batch
__device__ __forceinline__ float affine(const float* __restrict__ v0,
                                        const float* __restrict__ M, int idx,
                                        const float* __restrict__ th, int nt,
                                        bool valid) {
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s = fmaf(M[idx * nt + t], valid ? th[t] : 0.f, s);
  return v0[idx] + s;
}

// non-negative floats order like their bits, and a NaN's bits are above all
__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(fabsf(v)); }

// ---------------------------------------------------------------------------
// Small composites: register-tiled, G in shared memory
// ---------------------------------------------------------------------------

// acc[r][c] += sum_{k<K} v[k ldv + r] g[k ldg + c]: the 8 x 4 tile product,
// three 16-byte shared-memory loads per 32 FMAs.
__device__ __forceinline__ void tile_product(float (&acc)[kTileRows][kTileCols],
                                             const float* __restrict__ g, int ldg,
                                             const float* __restrict__ v, int ldv,
                                             int K) {
  if (K <= 0) return;
  // the loads of step k + 1 are issued before the FMAs of step k
  float4 g4 = *reinterpret_cast<const float4*>(g);
  float4 va = *reinterpret_cast<const float4*>(v);
  float4 vb = *reinterpret_cast<const float4*>(v + 4);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int kn = min(k + 1, K - 1);
    const float4 g4n = *reinterpret_cast<const float4*>(g + kn * ldg);
    const float4 van = *reinterpret_cast<const float4*>(v + kn * ldv);
    const float4 vbn = *reinterpret_cast<const float4*>(v + kn * ldv + 4);
    const float vr[kTileRows] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
    const float gc[kTileCols] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = fmaf(vr[r], gc[c], acc[r][c]);
    g4 = g4n;
    va = van;
    vb = vbn;
  }
}

__device__ __forceinline__ void store_col(float* dst, const float (&t)[kTileRows][kTileCols],
                                          int c) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(t[0][c], t[1][c], t[2][c], t[3][c]);
  d4[1] = make_float4(t[4][c], t[5][c], t[6][c], t[7][c]);
}

__device__ __forceinline__ void store_rows(float* dst, const float (&v)[kTileRows]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(v[0], v[1], v[2], v[3]);
  d4[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load_col(float (&v)[kTileRows], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const float4 a = s4[0], b = s4[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 16 bytes from device memory into shared memory without passing registers
__device__ __forceinline__ void copy16_async(float* smem_dst, const float* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst))),
                  "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

#define RTMPC_ADMM_PARAMS                                                      \
  const float *__restrict__ theta, const float *__restrict__ x_in,             \
      const float *__restrict__ y_in, const float *__restrict__ z_in,          \
      const float *__restrict__ Gxc, const float *__restrict__ Gsc,            \
      const float *__restrict__ Kcat, const float *__restrict__ As,            \
      const float *__restrict__ Ps, const float *__restrict__ Mq,              \
      const float *__restrict__ Ml, const float *__restrict__ Mu,              \
      const float *__restrict__ q0, const float *__restrict__ l0,              \
      const float *__restrict__ u0, const float *__restrict__ rho,             \
      const float *__restrict__ rho_inv, const float *__restrict__ alpha_p,    \
      float *__restrict__ x_out, float *__restrict__ y_out,                    \
      float *__restrict__ z_out, float *__restrict__ r_prim,                   \
      float *__restrict__ r_dual, int B, int n, int m, int nt, int iters
#define RTMPC_ADMM_ARGS                                                        \
  theta, x_in, y_in, z_in, Gxc, Gsc, Kcat, As, Ps, Mq, Ml, Mu, q0, l0, u0,     \
      rho, rho_inv, alpha_p, x_out, y_out, z_out, r_prim, r_dual, B, n, m, nt, \
      iters

// Shared-memory floats of admm_kernel<RG> (the host sizes the launch with it):
// G, the iterate, l and u, and at 64 rows a block also z.
__host__ __device__ inline size_t small_smem_floats(int n, int m, int rows) {
  const int nmp = (n + m + 3) & ~3;
  const int mcg = nmp / 4 - n / 4;
  const int rs = rows + 4;
  return (size_t)nmp * nmp + (size_t)nmp * rs +
         (size_t)(rows == 64 ? 12 : 8) * mcg * rs;
}

template <int RG>
__global__ void __launch_bounds__(RG == 8 ? kMaxThreadsSmall : 192, 1)
admm_kernel(RTMPC_ADMM_PARAMS) {
  constexpr int R = kTileRows * RG;  // batch rows a block
  constexpr int RS = R + 4;          // floats between columns of a k-major buffer
  // 10 warps leave a thread 168 registers (3 warps on one scheduler's 16K):
  // z goes to shared memory there, so that the product's loads can run ahead
  constexpr bool ZS = RG == 8;
  extern __shared__ __align__(128) float smem[];
  const int nm = n + m;
  const int nmp = (nm + 3) & ~3;     // columns padded to whole tiles
  const int ncg = nmp / 4;           // column groups
  const int n4 = n / 4;              // first column group that holds a constraint
  const int mcg = ncg - n4;
  float* Gs = smem;                  // (nmp, nmp): G, rows in position order
  float* V = Gs + nmp * nmp;         // (nmp, RS): the iterate, k-major, permuted
  float* Lb = V + nmp * RS;          // (4 mcg, RS): l, permuted; after the loop, y
  float* Ub = Lb + 4 * mcg * RS;     // (4 mcg, RS): u, permuted
  float* Zb = Ub + 4 * mcg * RS;     // (4 mcg, RS): z, permuted (ZS only)
  __shared__ int rp_bits[R];
  __shared__ int rd_bits[R];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunks = (ncg + 7) / 8;         // column chunks of 8 groups
  const int rg = (warp / nchunks) * 4 + (lane >> 3);
  const int cg_raw = (warp % nchunks) * 8 + (lane & 7);
  const bool active = cg_raw < ncg;          // idle lanes read a valid tile
  const int cgi = active ? cg_raw : ncg - 1;
  const int r8 = rg * kTileRows;
  const int j0 = cgi * kTileCols;            // first column of the tile
  const int row0 = blockIdx.x * R;
  const float alpha = *alpha_p;

  // whole 16-byte words of the matrices can be copied asynchronously
  const bool vec = nm % 4 == 0 &&
                   ((uintptr_t)Gxc | (uintptr_t)Gsc | (uintptr_t)Kcat) % 16 == 0;

  // ---- q Kcat: Kcat staged in G's buffer, q in the iterate's, natural order
  if (vec) {
    for (int e = tid; e < n * ncg; e += nthreads) copy16_async(Gs + 4 * e, Kcat + 4 * e);
  } else {
    for (int e = tid; e < n * nmp; e += nthreads) {
      const int k = e / nmp, c = e - k * nmp;
      Gs[e] = c < nm ? Kcat[k * nm + c] : 0.f;
    }
  }
  for (int e = tid; e < n * R; e += nthreads) {
    const int k = e / R, r = e - k * R;
    const int row = row0 + r;
    V[k * RS + r] = affine(q0, Mq, k, theta + (size_t)row * nt, nt, row < B);
  }
  for (int e = tid; e < m * R; e += nthreads) {
    const int i = e / R, r = e - i * R;
    const int row = row0 + r;
    const int j = n + i;
    const int pos = (j & 3) * mcg + (j >> 2) - n4;
    const float* th = theta + (size_t)row * nt;
    Lb[pos * RS + r] = affine(l0, Ml, i, th, nt, row < B);
    Ub[pos * RS + r] = affine(u0, Mu, i, th, nt, row < B);
  }
  if (tid < R) {
    rp_bits[tid] = 0;
    rd_bits[tid] = 0;
  }
  copy_async_wait();
  __syncthreads();

  float qc[kTileRows][kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) qc[r][c] = 0.f;
  tile_product(qc, Gs + j0, nmp, V + r8, RS, n);
  __syncthreads();  // Kcat and q are read before G and the iterate replace them

  // ---- G into shared memory, row j at position (j % 4) ncg + j / 4; the
  // copies run while the state below is read
  if (vec) {
    for (int e = tid; e < nm * ncg; e += nthreads) {
      const int j = e / ncg, c4 = e - j * ncg;
      const float* src = (j < n ? Gxc + j * nm : Gsc + (j - n) * nm) + 4 * c4;
      copy16_async(Gs + ((j & 3) * ncg + (j >> 2)) * nmp + 4 * c4, src);
    }
  } else {
    for (int e = tid; e < nmp * nmp; e += nthreads) {
      const int j = e / nmp, c = e - j * nmp;
      float g = 0.f;
      if (j < nm && c < nm) g = j < n ? Gxc[j * nm + c] : Gsc[(j - n) * nm + c];
      Gs[((j & 3) * ncg + (j >> 2)) * nmp + c] = g;
    }
  }

  // ---- the tile's state: a = x (x column) or y (constraint column), b = z
  float a[kTileRows][kTileCols];
  [[maybe_unused]] float b[ZS ? 1 : kTileRows][kTileCols];  // z, where it stays in registers
  float rho_c[kTileCols], rinv_c[kTileCols];
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) {
    const int j = j0 + c;
    const bool is_c = j >= n && j < nm;
    rho_c[c] = is_c ? rho[j - n] : 0.f;
    rinv_c[c] = is_c ? rho_inv[j - n] : 0.f;
    float v[kTileRows][kTileCols];
    float zc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int row = row0 + r8 + r;
      const bool valid = row < B;
      a[r][c] = zc[r] = 0.f;
      if (j < n) {
        a[r][c] = valid ? x_in[(size_t)row * n + j] : 0.f;
      } else if (is_c) {
        a[r][c] = valid ? y_in[(size_t)row * m + j - n] : 0.f;
        zc[r] = valid ? z_in[(size_t)row * m + j - n] : 0.f;
      }
      v[r][c] = j < n ? a[r][c] : rho_c[c] * zc[r] - a[r][c];
      if constexpr (!ZS) b[r][c] = zc[r];
    }
    if (active) store_col(V + (c * ncg + cgi) * RS + r8, v, c);
    if constexpr (ZS) {
      if (active && is_c) store_rows(Zb + (c * mcg + cgi - n4) * RS + r8, zc);
    }
  }
  copy_async_wait();
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float acc[kTileRows][kTileCols];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.f;
    tile_product(acc, Gs + j0, nmp, V + r8, RS, nmp);
    __syncthreads();  // every read of the iterate is done before it is overwritten
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int j = j0 + c;
      if (!active || j >= nm) continue;  // a padded column stays zero
      if (j < n) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          a[r][c] = alpha * (acc[r][c] - qc[r][c]) + (1.f - alpha) * a[r][c];
          acc[r][c] = a[r][c];
        }
      } else {
        const int pos = c * mcg + cgi - n4;
        float lo[kTileRows], hi[kTileRows], zc[kTileRows];
        load_col(lo, Lb + pos * RS + r8);
        load_col(hi, Ub + pos * RS + r8);
        if constexpr (ZS) load_col(zc, Zb + pos * RS + r8);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          if constexpr (!ZS) zc[r] = b[r][c];
          const float zm = alpha * (acc[r][c] - qc[r][c]) + (1.f - alpha) * zc[r];
          const float zn = clip_nan(zm + a[r][c] * rinv_c[c], lo[r], hi[r]);
          a[r][c] = a[r][c] + rho_c[c] * (zm - zn);
          zc[r] = zn;
          if constexpr (!ZS) b[r][c] = zn;
          acc[r][c] = rho_c[c] * zn - a[r][c];
        }
        if constexpr (ZS) store_rows(Zb + pos * RS + r8, zc);
      }
      store_col(V + (c * ncg + cgi) * RS + r8, acc, c);
    }
    __syncthreads();  // the new iterate is complete before the next product
  }

  // ---- final iterate out; x and y k-major in natural order for the residuals
  float* Yb = Lb;
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) {
    const int j = j0 + c;
    if (!active || j >= nm) continue;
    if (j < n) store_col(V + j * RS + r8, a, c);
    else store_col(Yb + (j - n) * RS + r8, a, c);
    float zc[kTileRows];
    if constexpr (ZS) {
      if (j >= n) load_col(zc, Zb + (c * mcg + cgi - n4) * RS + r8);
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int row = row0 + r8 + r;
      if (row >= B) continue;
      if (j < n) {
        x_out[(size_t)row * n + j] = a[r][c];
      } else {
        if constexpr (!ZS) zc[r] = b[r][c];
        y_out[(size_t)row * m + j - n] = a[r][c];
        z_out[(size_t)row * m + j - n] = zc[r];
      }
    }
  }
  // rows k < n: [Ps' | As'] (column j: Ps[j, k], column n + i: As[i, k]);
  // rows n + i: [As[i, :] | 0]
#pragma unroll 8
  for (int e = tid; e < n * nmp; e += nthreads) {
    const int k = e / nmp, c = e - k * nmp;
    Gs[e] = c < n ? Ps[(size_t)c * n + k] : (c < nm ? As[(size_t)(c - n) * n + k] : 0.f);
  }
#pragma unroll 8
  for (int e = tid; e < m * nmp; e += nthreads) {
    const int i = e / nmp, c = e - i * nmp;
    Gs[n * nmp + e] = c < n ? As[(size_t)i * n + c] : 0.f;
  }
  __syncthreads();

  // x column j: Ps[j, :] x + As[:, j]' y (+ q_j below); constraint column
  // n + i: As[i, :] x (- z_i below)
  float res[kTileRows][kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) res[r][c] = 0.f;
  tile_product(res, Gs + j0, nmp, V + r8, RS, n);
  tile_product(res, Gs + n * nmp + j0, nmp, Yb + r8, RS, m);
  if constexpr (ZS) {
    // res <- As x - z on the constraint columns
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int j = j0 + c;
      if (!active || j < n || j >= nm) continue;
      float zc[kTileRows];
      load_col(zc, Zb + (c * mcg + cgi - n4) * RS + r8);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) res[r][c] -= zc[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) res[r][c] -= b[r][c];
  }
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int row = row0 + r8 + r;
    int rp = 0, rd = 0;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int j = j0 + c;
      if (!active || j >= nm) continue;
      if (j < n) {
        const float q = affine(q0, Mq, j, theta + (size_t)row * nt, nt, row < B);
        rd = max(rd, abs_bits(res[r][c] + q));
      } else {
        rp = max(rp, abs_bits(res[r][c]));
      }
    }
    // the 8 column groups of a row group sit in 8 neighbouring lanes
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      rp = max(rp, __shfl_xor_sync(0xffffffffu, rp, s));
      rd = max(rd, __shfl_xor_sync(0xffffffffu, rd, s));
    }
    if ((lane & 7) == 0) {
      atomicMax(&rp_bits[r8 + r], rp);
      atomicMax(&rd_bits[r8 + r], rd);
    }
  }
  __syncthreads();
  if (tid < R && row0 + tid < B) {
    r_prim[row0 + tid] = __int_as_float(rp_bits[tid]);
    r_dual[row0 + tid] = __int_as_float(rd_bits[tid]);
  }
}

// ---------------------------------------------------------------------------
// Large composites: columns split over a thread-block cluster, G from L2
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fma_tile4(float (&acc)[4], const float4 g, float v) {
  acc[0] = fmaf(v, g.x, acc[0]);
  acc[1] = fmaf(v, g.y, acc[1]);
  acc[2] = fmaf(v, g.z, acc[2]);
  acc[3] = fmaf(v, g.w, acc[3]);
}

// M[k, jc .. jc + 3], M's rows k < n taken from M0 and the others from M1
// (both nm wide).  VEC: nm and jc are multiples of 4 and the matrices
// 16-byte aligned, so the 4 values are one load.
template <bool VEC>
__device__ __forceinline__ float4 load_g(const float* __restrict__ M0,
                                         const float* __restrict__ M1, int n, int nm,
                                         int jc, int k) {
  const float* row = (k < n ? M0 + (size_t)k * nm : M1 + (size_t)(k - n) * nm) + jc;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row));
  float4 g;
  g.x = __ldg(row);
  g.y = jc + 1 < nm ? __ldg(row + 1) : 0.f;
  g.z = jc + 2 < nm ? __ldg(row + 2) : 0.f;
  g.w = jc + 3 < nm ? __ldg(row + 3) : 0.f;
  return g;
}

template <int RC>
__device__ __forceinline__ void fma_step(float (&acc)[RC][4], const float4 g,
                                         const float* __restrict__ Vk) {
  const float4* v4 = reinterpret_cast<const float4*>(Vk);
#pragma unroll
  for (int q = 0; q < RC / 4; ++q) {
    const float4 v = v4[q];
    fma_tile4(acc[4 * q + 0], g, v.x);
    fma_tile4(acc[4 * q + 1], g, v.y);
    fma_tile4(acc[4 * q + 2], g, v.z);
    fma_tile4(acc[4 * q + 3], g, v.w);
  }
}

template <int RC>
__device__ __forceinline__ void flush_tile(float (&acc)[RC][4], float* __restrict__ pb,
                                           int WP, bool first) {
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    float4* p = reinterpret_cast<float4*>(pb + r * WP);
    float4 s = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (!first) {
      const float4 o = *p;
      s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
    }
    *p = s;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
}

// One warp's slice [k0, k1) of the product for a lane's 4 columns jc..jc+3
// and the cluster's RC rows: pb[r WP + c] = sum_k V[k RC + r] M[k, jc + c].
// G comes straight from L2 in blocks of kPrefetch rows, the next block's
// loads issued before the current block's FMAs; the sum is flushed to pb
// every kChunk terms, so no FMA chain is longer than that.
template <int RC, bool VEC>
__device__ __forceinline__ void slice_product(const float* __restrict__ M0,
                                              const float* __restrict__ M1, int n,
                                              int nm, int jc, int k0, int k1,
                                              const float* __restrict__ V,
                                              float* __restrict__ pb, int WP) {
  float acc[RC][4];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  bool first = true;
  const int nfull = (k1 - k0) / kPrefetch;
  float4 g[kPrefetch];
  if (nfull > 0) {
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) g[u] = load_g<VEC>(M0, M1, n, nm, jc, k0 + u);
  }
  int k = k0;
  for (int blk = 0; blk < nfull; ++blk, k += kPrefetch) {
    float4 gn[kPrefetch];
    if (blk + 1 < nfull) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u)
        gn[u] = load_g<VEC>(M0, M1, n, nm, jc, k + kPrefetch + u);
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) fma_step<RC>(acc, g[u], V + (size_t)(k + u) * RC);
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) g[u] = gn[u];
    if ((blk + 1) % (kChunk / kPrefetch) == 0) {
      flush_tile<RC>(acc, pb, WP, first);
      first = false;
    }
  }
  for (; k < k1; ++k)
    fma_step<RC>(acc, load_g<VEC>(M0, M1, n, nm, jc, k), V + (size_t)k * RC);
  flush_tile<RC>(acc, pb, WP, first);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every block of the cluster sends the `bytes_own` bytes at `slice` (its own
// columns of a k-major buffer, written by its threads just before) to the
// same place in the 7 other blocks' shared memory, as one bulk copy each,
// and waits until the other blocks' slices (`bytes_expect` bytes in all)
// have arrived in its own buffer.  The copies complete on the receiver's
// mbarrier `mbar` (transaction bytes), which the receiver arms itself and
// waits on at `parity`.  All threads of the block call it.
__device__ __forceinline__ void exchange_slices(const float* slice, uint32_t bytes_own,
                                                uint32_t bytes_expect, uint64_t* mbar,
                                                uint32_t parity, int cb, int tid) {
  // the threads' stores to the slice, before the copy engine reads it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t mb = smem_u32(mbar);
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(mb), "r"(bytes_expect) : "memory");
    if (bytes_own > 0) {
      const uint32_t src = smem_u32(slice);
      for (int t = 0; t < kCluster; ++t) {
        if (t == cb) continue;
        uint32_t dst, rmb;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(src), "r"(t));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rmb) : "r"(mb), "r"(t));
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(dst), "r"(src), "r"(bytes_own), "r"(rmb) : "memory");
      }
    }
  }
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mb), "r"(parity) : "memory");
  } while (!done);
}

// Shared-memory floats of admm_kernel_cluster<RC, NH>: the iterate twice, the
// warps' partial tiles, l and u of the owned elements.
constexpr size_t cluster_smem_floats(int nm, int RC, int NH) {
  return (size_t)2 * nm * RC + (size_t)(kWarpsC / NH) * RC * 128 * NH +
         (size_t)2 * RC * 128 * NH;
}

// RC rows a cluster; NH halves of 128 columns a block (its slice is at most
// 128 NH columns wide).  8 warps: NH halves x 8 / NH slices of k.  The 256
// threads are also the owners of the block's RC x 128 NH elements, 8 rows of
// one column each.
template <int RC, int NH, bool VEC>
__global__ void __launch_bounds__(kThreadsC, 1)
admm_kernel_cluster(RTMPC_ADMM_PARAMS) {
  constexpr int KS = kWarpsC / NH;   // slices of k
  constexpr int WP = 128 * NH;       // columns of a block's partial buffer
  constexpr int RO = 8;              // rows an owner thread holds
  static_assert(WP * RC == RO * kThreadsC, "one owner thread per 8 rows of a column");
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nm = n + m;
  float* Vc = smem;                  // (nm, RC): [x | rho z - y], k-major; q at first
  float* Vn = Vc + (size_t)nm * RC;  // the next iterate; y after the loop
  float* Pb = Vn + (size_t)nm * RC;  // (KS, RC, WP): the warps' partial tiles
  float4* Lo = reinterpret_cast<float4*>(Pb + (size_t)KS * RC * WP);  // (RC / 4, WP)
  float4* Hi = Lo + (RC / 4) * WP;
  __shared__ int rp_bits[RC];
  __shared__ int rd_bits[RC];
  __shared__ __align__(8) uint64_t mbar[2];  // one for each iterate buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cb = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * RC;
  const int w = (((nm + kCluster - 1) / kCluster) + 3) & ~3;  // columns a block
  const int col0 = cb * w;
  const float alpha = *alpha_p;

  // the product's role: warp = (column half, slice of k), lane = 4 columns
  const int ks = warp % KS;
  const int cl4 = ((warp / KS) * 32 + lane) * 4;
  const int jc = col0 + cl4;
  const bool cact = cl4 < w && jc < nm;
  float* pb = Pb + (size_t)ks * RC * WP + cl4;

  // the owner's role: column col0 + ocol, rows ro .. ro + 7 of the cluster's
  const int ocol = tid % WP;
  const int ro = (tid / WP) * RO;
  const int j = col0 + ocol;
  const bool oact = ocol < w && j < nm;
  const bool is_x = oact && j < n;
  const bool is_c = oact && j >= n;
  const int i = j - n;
  const int lu = (ro / 4) * WP + ocol;  // the owner's first float4 of Lo / Hi
  const size_t vo = (size_t)j * RC + ro;  // and its place in an iterate buffer
  // the block's slice of an iterate buffer, and what the other blocks send
  const int own_cols = max(0, min(col0 + w, nm) - col0);
  const size_t slice = (size_t)min(col0, nm) * RC;
  const uint32_t bytes_own = (uint32_t)(own_cols * RC * sizeof(float));
  const uint32_t bytes_expect = (uint32_t)((nm - own_cols) * RC * sizeof(float));

  if (tid < RC) {
    rp_bits[tid] = 0;
    rd_bits[tid] = 0;
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&mbar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&mbar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // q of the cluster's rows, k-major, in every block
  for (int e = tid; e < n * RC; e += kThreadsC) {
    const int k = e / RC, r = e - k * RC;
    const int row = row0 + r;
    Vc[e] = affine(q0, Mq, k, theta + (size_t)row * nt, nt, row < B);
  }
  cluster.sync();  // q complete; every block has started and armed its barriers

  // ---- hoisted linear term q Kcat of the owned elements
  if (cact) {
    const int klen = (n + KS - 1) / KS;
    slice_product<RC, VEC>(Kcat, Kcat, n, nm, jc, min(ks * klen, n),
                           min((ks + 1) * klen, n), Vc, pb, WP);
  }
  __syncthreads();

  float a[RO], b[RO], qc[RO];
  float rho_o = 0.f, rinv_o = 0.f;
  {
    float v[RO], lo[RO], hi[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      a[r] = b[r] = qc[r] = v[r] = lo[r] = hi[r] = 0.f;
      const int row = row0 + ro + r;
      const bool valid = row < B;
      const float* th = theta + (size_t)row * nt;
      if (oact) {
        for (int s = 0; s < KS; ++s) qc[r] += Pb[((size_t)s * RC + ro + r) * WP + ocol];
      }
      if (is_x) {
        a[r] = valid ? x_in[(size_t)row * n + j] : 0.f;
        v[r] = a[r];
      } else if (is_c) {
        rho_o = rho[i];
        rinv_o = rho_inv[i];
        lo[r] = affine(l0, Ml, i, th, nt, valid);
        hi[r] = affine(u0, Mu, i, th, nt, valid);
        a[r] = valid ? y_in[(size_t)row * m + i] : 0.f;
        b[r] = valid ? z_in[(size_t)row * m + i] : 0.f;
        v[r] = rho_o * b[r] - a[r];
      }
    }
    Lo[lu] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    Lo[lu + WP] = make_float4(lo[4], lo[5], lo[6], lo[7]);
    Hi[lu] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    Hi[lu + WP] = make_float4(hi[4], hi[5], hi[6], hi[7]);
    if (oact) {
      float4* dst = reinterpret_cast<float4*>(Vn + vo);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  // Buffer 1 takes the first iterate (exchange 0 of its barrier), buffer 0
  // the second, and so on: exchange e goes to buffer (e + 1) % 2 and is that
  // barrier's use e / 2, whose parity is (e / 2) % 2.
  uint32_t ex = 0;
  exchange_slices(Vn + slice, bytes_own, bytes_expect, &mbar[1], 0, cb, tid);
  {
    float* t = Vc; Vc = Vn; Vn = t;
  }

  const int klen = (nm + KS - 1) / KS;
  const int k0 = min(ks * klen, nm), k1 = min((ks + 1) * klen, nm);
  for (int it = 0; it < iters; ++it) {
    if (cact) slice_product<RC, VEC>(Gxc, Gsc, n, nm, jc, k0, k1, Vc, pb, WP);
    __syncthreads();  // the block's partial tiles are complete
    if (oact) {
      float v[RO];
      const float4 l0v = Lo[lu], l1v = Lo[lu + WP], h0v = Hi[lu], h1v = Hi[lu + WP];
      const float lo[RO] = {l0v.x, l0v.y, l0v.z, l0v.w, l1v.x, l1v.y, l1v.z, l1v.w};
      const float hi[RO] = {h0v.x, h0v.y, h0v.z, h0v.w, h1v.x, h1v.y, h1v.z, h1v.w};
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        float t = 0.f;
#pragma unroll
        for (int s = 0; s < KS; ++s) t += Pb[((size_t)s * RC + ro + r) * WP + ocol];
        t -= qc[r];
        if (is_x) {
          a[r] = alpha * t + (1.f - alpha) * a[r];
          v[r] = a[r];
        } else {
          const float zm = alpha * t + (1.f - alpha) * b[r];
          const float zn = clip_nan(zm + a[r] * rinv_o, lo[r], hi[r]);
          a[r] = a[r] + rho_o * (zm - zn);
          b[r] = zn;
          v[r] = rho_o * zn - a[r];
        }
      }
      float4* dst = reinterpret_cast<float4*>(Vn + vo);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    // A block sends its slice of the next iterate after its product, and
    // gets a peer's only after that peer's: when exchange e + 1 overwrites
    // the buffer read now, every block has sent exchange e, so has read it.
    ++ex;
    exchange_slices(Vn + slice, bytes_own, bytes_expect, &mbar[(ex + 1) & 1],
                    (ex >> 1) & 1, cb, tid);
    float* t = Vc; Vc = Vn; Vn = t;
  }

  // ---- final iterate out; [x | y] into every block's spare iterate buffer
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = row0 + ro + r;
    if (row >= B) continue;
    if (is_x) {
      x_out[(size_t)row * n + j] = a[r];
    } else if (is_c) {
      y_out[(size_t)row * m + i] = a[r];
      z_out[(size_t)row * m + i] = b[r];
    }
  }
  if (oact) {
    float4* dst = reinterpret_cast<float4*>(Vn + vo);
    dst[0] = make_float4(a[0], a[1], a[2], a[3]);
    dst[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
  ++ex;
  exchange_slices(Vn + slice, bytes_own, bytes_expect, &mbar[(ex + 1) & 1],
                  (ex >> 1) & 1, cb, tid);  // [x | y] complete in every block

  const float* X = Vn + ro;                   // x_k of the owner's rows at X[k RC]
  const float* Y = Vn + (size_t)n * RC + ro;  // y_i at Y[i RC]
  float res[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) res[r] = 0.f;
  if (is_c) {
    // primal residual row i: As[i, :] x - z_i
    for (int k = 0; k < n; ++k) {
      const float g = As[(size_t)i * n + k];
#pragma unroll
      for (int r = 0; r < RO; ++r) res[r] = fmaf(X[(size_t)k * RC + r], g, res[r]);
    }
  } else if (is_x) {
    // dual residual entry j: Ps[j, :] x + q_j + As[:, j]' y
    for (int k = 0; k < n; ++k) {
      const float g = Ps[(size_t)j * n + k];
#pragma unroll
      for (int r = 0; r < RO; ++r) res[r] = fmaf(X[(size_t)k * RC + r], g, res[r]);
    }
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const int row = row0 + ro + r;
      res[r] += affine(q0, Mq, j, theta + (size_t)row * nt, nt, row < B);
    }
    for (int kb = 0; kb < m; kb += kBlockL) {
      float part[RO];
#pragma unroll
      for (int r = 0; r < RO; ++r) part[r] = 0.f;
      const int ke = min(kb + kBlockL, m);
      for (int k = kb; k < ke; ++k) {
        const float g = As[(size_t)k * n + j];
#pragma unroll
        for (int r = 0; r < RO; ++r) part[r] = fmaf(Y[(size_t)k * RC + r], g, part[r]);
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) res[r] += part[r];
    }
  }
  // the cluster's maxima, in its first block's shared memory
  int* rp0 = cluster.map_shared_rank(rp_bits, 0);
  int* rd0 = cluster.map_shared_rank(rd_bits, 0);
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    if (is_c) atomicMax(rp0 + ro + r, abs_bits(res[r] - b[r]));
    else if (is_x) atomicMax(rd0 + ro + r, abs_bits(res[r]));
  }
  cluster.sync();  // also: no block leaves while its shared memory is in use
  if (cb == 0 && tid < RC && row0 + tid < B) {
    r_prim[row0 + tid] = __int_as_float(rp_bits[tid]);
    r_dual[row0 + tid] = __int_as_float(rd_bits[tid]);
  }
}

template <int RC, int NH, bool VEC>
cudaError_t launch_cluster(RTMPC_ADMM_PARAMS, cudaStream_t stream) {
  auto kernel = admm_kernel_cluster<RC, NH, VEC>;
  const size_t smem = cluster_smem_floats(n + m, RC, NH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + RC - 1) / RC) * kCluster);
  cfg.blockDim = dim3(kThreadsC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, RTMPC_ADMM_ARGS);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int RG>
cudaError_t launch_small(RTMPC_ADMM_PARAMS, int threads, size_t smem,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel<RG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = kTileRows * RG;
  const dim3 grid((unsigned)((B + rows - 1) / rows));
  admm_kernel<RG><<<grid, threads, smem, stream>>>(RTMPC_ADMM_ARGS);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one solve of `iters`
// iterations for B rows on `stream` and returns cudaGetLastError() of the
// launch (0 on success); a refused launch never runs, so the caller must check.
// n + m <= 192 runs admm_kernel (G in shared memory; 64 rows a block where
// they fit beside G, else 32), n + m <= 2048 admm_kernel_cluster (G from L2;
// 16 rows a cluster up to 1024 columns, 8 above); a larger QP is refused.
extern "C" int rtmpc_admm_solve_f32(RTMPC_ADMM_PARAMS, int device, void* stream_p) {
  const int nm = n + m;
  if (B <= 0 || n <= 0 || m <= 0 || nt < 0 || iters < 0 || nm > kMaxColsLarge)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t stream = (cudaStream_t)stream_p;
  if (nm > kMaxColsSmall) {
    const bool vec = nm % 4 == 0 && ((uintptr_t)Gxc | (uintptr_t)Gsc | (uintptr_t)Kcat) % 16 == 0;
    if (nm <= 128 * kCluster) {
      return (int)(vec ? launch_cluster<16, 1, true>(RTMPC_ADMM_ARGS, stream)
                       : launch_cluster<16, 1, false>(RTMPC_ADMM_ARGS, stream));
    }
    return (int)(vec ? launch_cluster<8, 2, true>(RTMPC_ADMM_ARGS, stream)
                     : launch_cluster<8, 2, false>(RTMPC_ADMM_ARGS, stream));
  }
  const int nchunks = (((nm + 3) / 4) + 7) / 8;
  const size_t smem64 = small_smem_floats(n, m, 64) * sizeof(float);
  if (smem64 <= kSmemLimit && 2 * nchunks * 32 <= kMaxThreadsSmall)
    return (int)launch_small<8>(RTMPC_ADMM_ARGS, 2 * nchunks * 32, smem64, stream);
  return (int)launch_small<4>(RTMPC_ADMM_ARGS, nchunks * 32,
                              small_smem_floats(n, m, 32) * sizeof(float), stream);
}

// Rows a block (small path) or a cluster (large path) for composites n + m
// wide: the batch sizes around it are what the ragged-tail tests use.
extern "C" int rtmpc_admm_rows_per_group(int n, int m) {
  const int nm = n + m;
  if (nm > kMaxColsSmall) return nm <= 128 * kCluster ? 16 : 8;
  const int nchunks = (((nm + 3) / 4) + 7) / 8;
  const bool r64 = small_smem_floats(n, m, 64) * sizeof(float) <= kSmemLimit &&
                   2 * nchunks * 32 <= kMaxThreadsSmall;
  return r64 ? 64 : 32;
}
