// K1's third path, "fac": the factored-form ADMM phase with the operator
// resident in shared memory, for small batches and for QPs wider than 1024
// columns (Hopper, sm_90a).
//
// Replaces: rtmpc_tpu/ops/qp_pallas.py:_admm_kernel (with admm_kernel.cu's
// two composite-form paths).  Same function, per batch row, in another
// order of the arithmetic:
//   q, l, u = q0 + Mq th, l0 + Ml th, u0 + Mu th        (th = theta row)
//   qk      = q Kinv'                                    (hoisted out of the loop)
//   iters x:  xt = (sigma x + (rho z - y) As) Kinv' - qk;   zt = xt As'
//             x <- a xt + (1-a) x;   zm = a zt + (1-a) z
//             z <- clip(zm + y / rho, l, u);   y <- y + rho (zm - z)
//   r_prim = max |As x - z|,   r_dual = max |Ps x + q + As' y|
// which is ops/qp.py:admm_solve's iteration with q Kinv' hoisted.
//
// What bounds it.  An iteration is three dependent products a row (2 (n^2
// + 2 n m) flops, the least the function needs: kernel_bench.roofline_ms),
// and at the batches this path takes the rows are few, so a phase is bound
// by the latency of `iters` dependent iterations (products, barriers, the
// cluster's exchange), not by FMA issue or bytes.  The composite paths
// spent that latency streaming [Gxc; Gsc] (3.3-12.4 MB above 192 columns)
// from L2 for one live row, or on a whole 64-row tile for one row.  This
// path keeps what an iteration reads in shared memory and does the factored
// form's work:
//  * Operator resident.  Kinv and the rows of As that a block owns stay in
//    dynamic shared memory for the whole launch, loaded once with 4-byte
//    asynchronous copies (cp.async; rows at a padded stride do not start
//    on 16-byte boundaries, so not bulk copies).  At one row a group the
//    two products whose terms run along a row (xt = rhs Kinv', zt = xt
//    As') read 4 terms a 16-byte load: Kinv and As row-major at a stride of
//    an odd number of 16-byte words, zeros in the padding, the iterate
//    padded to 4.  With more rows a group a load of the iterate brings
//    4-8 rows of one term, so every operator load is one float: Kinv
//    transposed and As at an odd stride, a lane a column or row.
//  * Where As does not fit one block (more than 256 rows, or n above 64:
//    every cartpole and extended QP), a cluster of 8 blocks splits As's
//    rows: block c owns rows [c ms, (c+1) ms) of them, ms = ceil(m / 8),
//    their l, u, y, z and rho; the last block owns the m - 7 ms left, which
//    may be none (100 + 49: it sends its partial, zeros) but never fewer:
//    the dispatch refuses m < 7 ms (100 + 20).  One exchange an iteration:
//      1. block c forms the partial p_c = (rho z - y)[:, slice c] As[slice c, :];
//      2. it sends p_c to the 7 other blocks as one bulk copy each through
//         distributed shared memory (cp.async.bulk.shared::cluster),
//         completing on the receiver's mbarrier, and waits on its own;
//      3. every block sums the 8 partials in the same order and forms
//         xt = (sigma x + sum p) Kinv' - qk and the new x redundantly, so x
//         is bit-identical in all 8 blocks and is never exchanged (7 x 2 n^2
//         flops a row more; splitting Kinv too would cost a second
//         exchange);
//      4. block c forms zt over its slice and the z / y update of its rows.
//    The partials' buffer is kept once (twice does not fit beside the
//    extended QP's operator at 16 rows), so a split cluster barrier
//    releases it: every thread arrives once it has read the partials, and
//    waits before it overwrites its own partial in the next iteration (by
//    then the other blocks' copies of it have landed too); the wait is
//    normally satisfied long before.  One mbarrier wait an iteration, no
//    cluster.sync() in the loop.  QPs up to 256 rows and 64 variables run
//    on one block with no exchange (the flagship, the condensed flagship,
//    the examples).
//  * Rows.  A group (one block, or one cluster) owns RC = 1, 4 or 16 batch
//    rows: one on one block (64 blocks at most) and up to 15 rows on a
//    cluster (the 8-block clusters an H100 holds at once), else the fewer
//    of 4 and 16 that keep the batch in one wave of the groups the card
//    holds (the occupancy API, asked once a shape).  A thread's unit is R
//    = min(RC, 8) rows of one output, accumulated in registers.  Where the
//    units leave threads idle, the terms are split into up to 8 slices of
//    at least 8 terms and the slices' sums added in shared memory in a
//    fixed order (one __syncthreads()).  Sums are chains of at most 64
//    terms added in order.
//  * Precision.  At one row a group the iterate buffers and every sum are
//    float64 over the float32 state and operator (a product of a float and
//    a double rounds once, in float64): the products are bound by latency
//    there, not by FMA issue, and in float32 the factored form's large
//    intermediate (rho z - y) As (rho = 500 on the equality rows) leaves y
//    several times further from float64 than the composite form does.
//    With more rows a group, FP32 FFMA with FP32 accumulation, as plain
//    float32 sums (the plain version follows the same rule).
//  * The state stays in registers with the thread that owns its unit: x and
//    qk (n-space units), y, z, l, u and rho (slice units); the thread that
//    finishes a product's unit applies its update, so no state moves.
//  * Tensor cores: no.  At RC <= 16 a product is latency-bound, and TF32
//    would break the float32 bars.
//  * After the loop the residuals as the cluster path computes them:
//    r_prim per slice, reduced into the first block with atomics; As' y as
//    partials exchanged once to the first block, which adds Ps x (Ps staged
//    where Kinv was) and q.
// The dispatch gives this path only QPs whose layout fits a block's shared
// memory at every rows a group it may run (factored_fits: every
// controller's QP; not the widest random QP, 256 + 1792); the others keep
// the composite paths.
// The ragged batch tail is masked (rows >= B read zeros and write nothing);
// nothing is padded on the host.  n <= 256 (the state's registers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsF = 256;     // threads a block
constexpr int kClusterF = 8;       // blocks a cluster where one block does not hold As
constexpr int kChunkF = 64;        // terms a chain before it is added to the sum
constexpr int kMaxSliceF = 256;    // rows of As a block (the state's registers)
// one row a group up to this batch: the 8-block clusters an NVIDIA H100
// holds at once at one block an SM (cudaOccupancyMaxActiveClusters reads
// 15), so up to it the batch runs in one wave; qp_cuda.FAC_ONE_ROW_B
constexpr int kFacOneRowB = 15;
constexpr int kOneBlockMaxN = 64;  // one block (no cluster) up to this n
constexpr size_t kSmemLimitF = 232448 - 1024;  // opt-in maximum less the static part
static_assert(kThreadsF == 256, "product() splits the terms by shifts of 256 threads");

__host__ __device__ constexpr int fac_rt(int rc) { return rc < 8 ? rc : 8; }

// The iterate buffers' and the sums' type: float64 at one row a group
// (the products there are bound by latency; float64 sums hold the factored
// form's accuracy), float32 above.
template <int RC>
using fac_vt = typename std::conditional<RC == 1, double, float>::type;
__host__ __device__ constexpr int fac_vw(int rc) { return rc == 1 ? 2 : 1; }  // floats a value

__host__ __device__ inline size_t round4(size_t v) { return (v + 3) & ~(size_t)3; }

// Slices of the terms for a product of `units` units over K terms: as many
// as leave no thread idle (a slice's threads a whole number of warps), at
// most 8, at least 8 terms a slice.  Returns log2 of the slices.
__host__ __device__ inline int fac_ks_log2(int units, int K) {
  const int up = (units + 31) & ~31;
  int s = 0;
  while (s < 3 && (kThreadsF >> (s + 1)) >= up && K >= (16 << s)) ++s;
  return s;
}

// Row stride of As's slice (and at one row a group of Kinv's) in shared
// memory.  At one row a group the products with the terms along a row read
// them 16 bytes at a time, so the stride is n rounded up to 4 and then to an
// odd number of 16-byte words: 8 lanes reading 16 bytes of 8 consecutive
// rows hit 8 different bank groups; the columns [n, ld) hold zeros.  With
// more rows a group every load is of one float (the iterate's rows are
// what a load of 16 bytes brings there), and an odd stride keeps a warp's
// 32 rows on 32 banks.
__host__ __device__ inline int fac_ld(int n, int rc) {
  const int n4 = (n + 3) & ~3;
  return rc > 1 ? (n | 1) : n4 % 8 == 4 ? n4 : n4 + 4;
}

// Shared-memory layout of admm_kernel_factored<RC> (offsets in floats).
struct FacLayout {
  int ms;          // rows of As a block
  int ld;          // row stride of As's slice; at RC = 1 of Kinv too (Kinv' at RC > 1)
  int n4;          // n rounded up to 4: the rows of an iterate buffer
  int kt;          // terms of the products over n (n4 at RC = 1: zeros pad them)
  size_t a, k, p, s, r, x, q, floats;
};

__host__ __device__ inline FacLayout fac_layout(int cl, int rc, int n, int m) {
  FacLayout L;
  L.ms = (m + cl - 1) / cl;
  L.ld = fac_ld(n, rc);
  L.n4 = (n + 3) & ~3;
  L.kt = rc == 1 ? L.n4 : n;
  const int R = fac_rt(rc), RG = rc / R;
  const int ms_last = m - (cl - 1) * L.ms;
  // the term slices' partial sums of the products whose terms are split
  const int pairs[5][2] = {{RG * n, L.ms}, {RG * n, ms_last}, {RG * n, L.kt},
                           {RG * L.ms, L.kt}, {RG * ms_last, L.kt}};
  size_t qf = 0;
  for (int i = 0; i < 5; ++i) {
    const int ks = 1 << fac_ks_log2(pairs[i][0], pairs[i][1]);
    const size_t f = ks > 1 ? (size_t)ks * pairs[i][0] * R : 0;
    if (f > qf) qf = f;
  }
  size_t o = 0;
  L.a = o;                                         // As slice (ms, ld)
  o += round4((size_t)L.ms * L.ld);
  L.k = o;                                         // Kinv; Ps after the loop
  o += round4((size_t)n * (rc == 1 ? L.ld : n));
  const int vw = fac_vw(rc);  // the buffers below hold fac_vt values
  L.p = o;                                         // 8 partials (n4, RC)
  if (cl > 1) o += (size_t)kClusterF * L.n4 * rc * vw;
  L.s = o;                                         // rho z - y of the slice (ms, RC)
  o += round4((size_t)L.ms * rc * vw);
  L.r = o;                                         // q, then the right-hand side (n4, RC)
  o += (size_t)L.n4 * rc * vw;
  L.x = o;                                         // xt (n4, RC)
  o += (size_t)L.n4 * rc * vw;
  L.q = o;                                         // the term slices' partial sums
  o += round4(qf * vw);
  L.floats = o;
  return L;
}

// One block where As has at most 256 rows and n is at most 64 (the layout
// then fits one block at any RC), else a cluster; qp_cuda mirrors it.
__host__ __device__ inline int fac_cl(int n, int m) {
  return m <= kMaxSliceF && n <= kOneBlockMaxN ? 1 : kClusterF;
}

__host__ __device__ inline bool fac_fits_rc(int cl, int rc, int n, int m) {
  return fac_layout(cl, rc, n, m).floats * sizeof(float) <= kSmemLimitF;
}

// jnp.clip semantics: maximum then minimum, and a NaN stays NaN.
template <class T>
__device__ __forceinline__ T clip_nan(T v, T lo, T hi) {
  const T t = v < lo ? lo : v;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from device memory into shared memory without passing registers
__device__ __forceinline__ void copy4_async(float* smem_dst, const float* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(smem_dst)), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void load_v(float (&v)[R], const float* __restrict__ p) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q + 0] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* __restrict__ p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// How a product reads its operator W(t, o) = W[o wo + t wt] in shared memory:
enum WMode {
  kCont,     // t contiguous (wt = 1), 16-byte rows, terms a multiple of 4
  kStrided   // o contiguous (wo = 1)
};

// out[r] = sum_{t0 <= t < t1} V[t RC + r] W[t wt], r < R.  Each chain
// (accumulator) takes at most kChunkF terms before it is added to the sum
// in order; where R < 4, 4 chains interleave.  The loads of a group of 4
// terms are issued before the FMAs of the group before it.
template <int RC, WMode M>
__device__ __forceinline__ void dot_rows(fac_vt<RC> (&out)[fac_rt(RC)],
                                         const fac_vt<RC>* __restrict__ V,
                                         const float* __restrict__ W, int wt,
                                         int t0, int t1) {
  constexpr int R = fac_rt(RC);
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.f;
  if constexpr (RC == 1) {
    // 4 chains, one a component of a group of 4 terms, in float64 (the
    // iterate is float64, the operator's floats are converted: the product
    // of a float and a double rounds once, in float64)
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    auto vgrp = [&](int t, double2& lo, double2& hi) {
      lo = *reinterpret_cast<const double2*>(V + t);
      hi = *reinterpret_cast<const double2*>(V + t + 2);
    };
    const int tg = M == kCont ? t1 : t0 + ((t1 - t0) & ~3);  // groups of 4
    if (tg > t0) {
      auto wgrp = [&](int t) -> float4 {
        if constexpr (M == kCont) return ld4(W + t);
        else
          return make_float4(W[(size_t)t * wt], W[(size_t)(t + 1) * wt],
                             W[(size_t)(t + 2) * wt], W[(size_t)(t + 3) * wt]);
      };
      float4 w = wgrp(t0);
      double2 va, vb;
      vgrp(t0, va, vb);
      for (int t = t0; t < tg; t += 4) {
        const int tn = t + 4 < tg ? t + 4 : t;
        const float4 wn = wgrp(tn);
        double2 van, vbn;
        vgrp(tn, van, vbn);
        a0 = fma(va.x, (double)w.x, a0);
        a1 = fma(va.y, (double)w.y, a1);
        a2 = fma(vb.x, (double)w.z, a2);
        a3 = fma(vb.y, (double)w.w, a3);
        w = wn;
        va = van;
        vb = vbn;
      }
    }
    for (int t = tg; t < t1; ++t) {
      a0 = fma(V[t], (double)W[(size_t)t * wt], a0);
    }
    out[0] = (a0 + a1) + (a2 + a3);
  } else if constexpr (M == kCont) {
    // 4 terms a group: one 16-byte load of W, R values of the iterate each
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    float4 w = ld4(W + t0);
    for (int t = t0; t < t1; t += 4) {
      const float4 wn = ld4(W + (t + 4 < t1 ? t + 4 : t));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[R];
        load_v<R>(v, V + (size_t)(t + c) * RC);
        const float wc = comp(w, c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], wc, acc[r]);
      }
      if (((t + 4 - t0) & (kChunkF - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          out[r] += acc[r];
          acc[r] = 0.f;
        }
      }
      w = wn;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += acc[r];
  } else {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const float w = W[(size_t)t * wt];
      float v[R];
      load_v<R>(v, V + (size_t)t * RC);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], w, acc[r]);
      if (((t + 1 - t0) & (kChunkF - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          out[r] += acc[r];
          acc[r] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += acc[r];
  }
}

// One product of the iteration for the group's RC rows: unit u = rg O + o
// is rows [rg R, rg R + R) of output o, sum_t V[t RC + rg R + r] W[o wo + t
// wt] over K terms.  Unit u is finished by thread u % 256 (its slot j = u /
// 256), which calls epi(j, rg, o, sums): the same thread for the same unit
// in every product of the same shape, so the state it updates stays in
// its registers.  Where the units leave threads idle, the terms are split
// in slices (of a multiple of 4 terms) whose partial sums meet in Q (one
// __syncthreads()).
template <int RC, int NU, WMode M, class Epi>
__device__ __forceinline__ void product(const fac_vt<RC>* __restrict__ V,
                                        const float* __restrict__ W, int wo, int wt,
                                        int O, int K, fac_vt<RC>* __restrict__ Q,
                                        int tid, Epi&& epi) {
  using VT = fac_vt<RC>;
  constexpr int R = fac_rt(RC);
  constexpr int RG = RC / R;  // 1 or 2
  const int units = RG * O;
  const int sl = fac_ks_log2(units, K);
  if (sl == 0) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = tid + j * kThreadsF;
      if (u < units) {
        const int rg = RG == 2 && u >= O ? 1 : 0, o = u - rg * O;
        VT acc[R];
        dot_rows<RC, M>(acc, V + rg * R, W + (size_t)o * wo, wt, 0, K);
        epi(j, rg, o, acc);
      }
    }
    return;
  }
  const int ks_n = 1 << sl;
  const int up_log2 = 8 - sl;  // kThreadsF = 256 threads: up = 256 / ks_n
  const int ks = tid >> up_log2, u = tid & ((1 << up_log2) - 1);
  if (u < units) {
    const int klen = (((K + ks_n - 1) >> sl) + 3) & ~3;
    const int rg = RG == 2 && u >= O ? 1 : 0, o = u - rg * O;
    VT acc[R];
    dot_rows<RC, M>(acc, V + rg * R, W + (size_t)o * wo, wt, min(ks * klen, K),
                    min((ks + 1) * klen, K));
#pragma unroll
    for (int r = 0; r < R; ++r) Q[(size_t)(ks * R + r) * units + u] = acc[r];
  }
  __syncthreads();
  if (tid < units) {  // units <= 128 here: slot 0
    const int rg = RG == 2 && tid >= O ? 1 : 0, o = tid - rg * O;
    VT acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      VT q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = k < ks_n ? Q[(size_t)(k * R + r) * units + tid] : 0.f;
      acc[r] = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]));
    }
    epi(0, rg, o, acc);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's own partial (`bytes` at `own`, written by its threads just
// before) goes to the same place in the other blocks' shared memory (all 7,
// or only block `only` where only >= 0) as one bulk copy each, completing
// on the receiver's mbarrier `mbar`; then the block waits on its own
// mbarrier, armed for `expect` bytes, at `parity`.  All threads call it.
__device__ __forceinline__ void exchange_partials(const void* own, uint32_t bytes,
                                                  uint32_t expect, uint64_t* mbar,
                                                  uint32_t parity, int cb, int tid,
                                                  int only) {
  // the threads' stores to the partial, before the copy engine reads it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t mb = smem_u32(mbar);
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(mb), "r"(expect) : "memory");
    const uint32_t src = smem_u32(own);
    for (int t = 0; t < kClusterF; ++t) {
      if (t == cb || (only >= 0 && t != only)) continue;
      uint32_t dst, rmb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(src), "r"(t));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rmb) : "r"(mb), "r"(t));
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(dst), "r"(src), "r"(bytes), "r"(rmb) : "memory");
    }
  }
  // a copy that never lands (a fault of this code) ends the launch with an
  // error after some 10 s instead of holding the card
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mb), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}

#define RTMPC_FAC_PARAMS                                                       \
  const float *__restrict__ theta, const float *__restrict__ x_in,             \
      const float *__restrict__ y_in, const float *__restrict__ z_in,          \
      const float *__restrict__ Kinv, const float *__restrict__ As,            \
      const float *__restrict__ Ps, const float *__restrict__ Mq,              \
      const float *__restrict__ Ml, const float *__restrict__ Mu,              \
      const float *__restrict__ q0, const float *__restrict__ l0,              \
      const float *__restrict__ u0, const float *__restrict__ rho,             \
      const float *__restrict__ rho_inv, const float *__restrict__ alpha_p,    \
      const float *__restrict__ sigma_p, float *__restrict__ x_out,            \
      float *__restrict__ y_out, float *__restrict__ z_out,                    \
      float *__restrict__ r_prim, float *__restrict__ r_dual, int B, int n,    \
      int m, int nt, int iters
#define RTMPC_FAC_ARGS                                                         \
  theta, x_in, y_in, z_in, Kinv, As, Ps, Mq, Ml, Mu, q0, l0, u0, rho, rho_inv, \
      alpha_p, sigma_p, x_out, y_out, z_out, r_prim, r_dual, B, n, m, nt, iters

// RC rows a group (1, 4 or 16).
template <int RC>
__global__ void __launch_bounds__(kThreadsF, 1)
admm_kernel_factored(RTMPC_FAC_PARAMS) {
  constexpr int R = fac_rt(RC);      // rows a unit
  constexpr int RG = RC / R;         // row groups
  constexpr int NU = RG;             // units a thread (n, ms <= 256)
  using VT = fac_vt<RC>;             // the iterate buffers' and sums' type
  extern __shared__ __align__(128) float smem[];
  __shared__ int rp_bits[RC];
  __shared__ int rd_bits[RC];
  __shared__ __align__(8) uint64_t full_bar;

  const int cl = fac_cl(n, m);
  const FacLayout L = fac_layout(cl, RC, n, m);
  const int tid = threadIdx.x;
  const int cb = cl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = (blockIdx.x / cl) * RC;
  const int s0 = cb * L.ms;                 // the block's first row of As
  const int msc = min(L.ms, m - s0);        // and its rows
  float* const As_s = smem + L.a;
  float* const Ks = smem + L.k;
  VT* const P = reinterpret_cast<VT*>(smem + L.p);
  VT* const S = reinterpret_cast<VT*>(smem + L.s);
  VT* const Rb = reinterpret_cast<VT*>(smem + L.r);
  VT* const X = reinterpret_cast<VT*>(smem + L.x);
  VT* const Q = reinterpret_cast<VT*>(smem + L.q);
  const int slot = L.n4 * RC;
  VT* const Pown = P + (size_t)cb * slot;
  const uint32_t slot_bytes = (uint32_t)(slot * sizeof(VT));
  const float alpha = *alpha_p, sigma = *sigma_p;
  const int lane = tid & 31, warp = tid >> 5;
  // The three products.  As's slice row-major at stride ld in shared
  // memory; Kinv row-major at stride ld at one row a group (the terms of
  // xt-type and zt-type products read 16 bytes at a time along a row), else
  // transposed (a lane a column, one float a load).
  //   xt-type: out[j] = sum_k V[k] Kinv[j, k]  (and Ps after the loop)
  //   zt-type: out[i] = sum_k V[k] As[s0 + i, k]
  //   p-type:  out[k] = sum_i V[i] As[s0 + i, k]
  constexpr bool C4 = RC == 1;
  const float* const Ag = As + (size_t)s0 * n;
  // Kinv, or Ps after the loop
  auto prod_k = [&](const VT* V, auto&& epi) {
    if constexpr (C4) product<RC, NU, kCont>(V, Ks, L.ld, 1, n, L.kt, Q, tid, epi);
    else product<RC, NU, kStrided>(V, Ks, 1, n, n, n, Q, tid, epi);
  };
  auto prod_zt = [&](const VT* V, auto&& epi) {
    if constexpr (C4) product<RC, NU, kCont>(V, As_s, L.ld, 1, msc, L.kt, Q, tid, epi);
    else product<RC, NU, kStrided>(V, As_s, L.ld, 1, msc, n, Q, tid, epi);
  };
  auto prod_p = [&](const VT* V, auto&& epi) {
    product<RC, NU, kStrided>(V, As_s, 1, L.ld, n, msc, Q, tid, epi);
  };
  // a warp a row, a lane a column, 4-byte asynchronous copies: row-major at
  // stride ld with zeros in the padding columns, or (Kinv and Ps at RC > 1)
  // transposed
  auto stage_rows = [&](float* dst, const float* src, int rows, bool transpose) {
    for (int i = warp; i < rows; i += kThreadsF / 32) {
      for (int k = lane; k < (transpose ? n : L.ld); k += 32) {
        if (transpose) copy4_async(dst + (size_t)k * n + i, src + (size_t)i * n + k);
        else if (k < n) copy4_async(dst + (size_t)i * L.ld + k, src + (size_t)i * n + k);
        else dst[(size_t)i * L.ld + k] = 0.f;
      }
    }
  };
  stage_rows(Ks, Kinv, n, !C4);
  stage_rows(As_s, Ag, msc, false);
  // zeros in the iterate buffers' padding rows (read by the 4-term loads)
  for (int e = tid; e < (L.n4 - n) * RC; e += kThreadsF) {
    Rb[n * RC + e] = 0.f;
    X[n * RC + e] = 0.f;
  }

  // ---- state: n-space units (x, qk) and slice units (y, z, l, u, rho)
  float x[NU][R], y[NU][R], z[NU][R], lo[NU][R], hi[NU][R];
  VT qk[NU][R];
  float rh[NU], ri[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    rh[j] = ri[j] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) x[j][r] = qk[j][r] = y[j][r] = z[j][r] = lo[j][r] = hi[j][r] = 0.f;
    const int u = tid + j * kThreadsF;
    if (u < RG * n) {
      const int rg = u >= n, k = u - rg * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rg * R + r;
        const bool valid = row < B;
        x[j][r] = valid ? x_in[(size_t)row * n + k] : 0.f;
        Rb[k * RC + rg * R + r] = affine(q0, Mq, k, theta + (size_t)row * nt, nt, valid);
      }
    }
    if (u < RG * msc) {
      const int rg = u >= msc, il = u - rg * msc, i = s0 + il;
      rh[j] = rho[i];
      ri[j] = rho_inv[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rg * R + r;
        const bool valid = row < B;
        const float* th = theta + (size_t)row * nt;
        lo[j][r] = affine(l0, Ml, i, th, nt, valid);
        hi[j][r] = affine(u0, Mu, i, th, nt, valid);
        y[j][r] = valid ? y_in[(size_t)row * m + i] : 0.f;
        z[j][r] = valid ? z_in[(size_t)row * m + i] : 0.f;
        S[il * RC + rg * R + r] = (VT)rh[j] * z[j][r] - y[j][r];
      }
    }
  }
  if (tid < RC) {
    rp_bits[tid] = 0;
    rd_bits[tid] = 0;
  }
  copy_async_wait();
  if (cl > 1) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&full_bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cg::this_cluster().sync();  // every block has started and armed its barrier
  } else {
    __syncthreads();
  }

  // ---- hoisted qk = q Kinv' (q in Rb)
  prod_k(Rb, [&](int j, int, int, const VT (&acc)[R]) {
#pragma unroll
                          for (int r = 0; r < R; ++r) qk[j][r] = acc[r];
                        });
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // every block has read the partials of the last exchange (so the copies
    // of this block's partial have landed) before it is overwritten
    if (cl > 1 && it > 0) cluster_wait();
    // p = (rho z - y) As over the slice; on one block straight into the
    // right-hand side sigma x + p
    prod_p(S, [&](int j, int rg, int k, const VT (&acc)[R]) {
                            VT* d = (cl > 1 ? Pown : Rb) + k * RC + rg * R;
#pragma unroll
                            for (int r = 0; r < R; ++r)
                              d[r] = cl > 1 ? acc[r] : fma((VT)sigma, (VT)x[j][r], acc[r]);
                          });
    if (cl > 1) {
      exchange_partials(Pown, slot_bytes, (kClusterF - 1) * slot_bytes, &full_bar,
                        it & 1, cb, tid, -1);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const int u = tid + j * kThreadsF;
        if (u < RG * n) {
          const int rg = u >= n, k = u - rg * n;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const VT* pp = P + k * RC + rg * R + r;
            VT t = pp[0];
#pragma unroll
            for (int c = 1; c < kClusterF; ++c) t += pp[(size_t)c * slot];
            Rb[k * RC + rg * R + r] = fma((VT)sigma, (VT)x[j][r], t);
          }
        }
      }
      __syncwarp();
      cluster_arrive();
    }
    __syncthreads();  // the right-hand side is complete
    // xt = rhs Kinv' - qk, and x
    prod_k(Rb, [&](int j, int rg, int k, const VT (&acc)[R]) {
                            VT* d = X + k * RC + rg * R;
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                              const VT xt = acc[r] - qk[j][r];
                              x[j][r] = (float)((VT)alpha * xt + (VT)(1.f - alpha) * x[j][r]);
                              d[r] = xt;
                            }
                          });
    __syncthreads();  // xt is complete
    // zt = xt As' over the slice, and z, y, rho z - y
    prod_zt(X, [&](int j, int rg, int il, const VT (&acc)[R]) {
                            VT* d = S + il * RC + rg * R;
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                              const VT zm = (VT)alpha * acc[r] + (VT)(1.f - alpha) * z[j][r];
                              const VT zn = clip_nan<VT>(zm + (VT)y[j][r] * ri[j],
                                                         lo[j][r], hi[j][r]);
                              y[j][r] = (float)(y[j][r] + (VT)rh[j] * (zm - zn));
                              z[j][r] = (float)zn;
                              d[r] = (VT)rh[j] * z[j][r] - y[j][r];
                            }
                          });
    __syncthreads();  // rho z - y is complete
  }
  if (cl > 1 && iters > 0) cluster_wait();

  // ---- residuals: Ps over Kinv (in the first block), x into X, y into S
  if (cb == 0) stage_rows(Ks, Ps, n, !C4);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = tid + j * kThreadsF;
    if (u < RG * n) {
      const int rg = u >= n, k = u - rg * n;
#pragma unroll
      for (int r = 0; r < R; ++r) X[k * RC + rg * R + r] = x[j][r];
    }
    if (u < RG * msc) {
      const int rg = u >= msc, il = u - rg * msc;
#pragma unroll
      for (int r = 0; r < R; ++r) S[il * RC + rg * R + r] = y[j][r];
    }
  }
  __syncthreads();
  int* rp0 = rp_bits;
  if (cl > 1) rp0 = cg::this_cluster().map_shared_rank(rp_bits, 0);
  // r_prim over the slice: As x - z, the group's maxima in its first block
  prod_zt(X, [&](int j, int rg, int, const VT (&acc)[R]) {
#pragma unroll
                          for (int r = 0; r < R; ++r)
                            atomicMax(rp0 + rg * R + r, abs_bits((float)(acc[r] - z[j][r])));
                        });
  __syncthreads();
  // As' y over the slice, then to the first block
  prod_p(S, [&](int, int rg, int k, const VT (&acc)[R]) {
                          VT* d = (cl > 1 ? Pown : Rb) + k * RC + rg * R;
#pragma unroll
                          for (int r = 0; r < R; ++r) d[r] = acc[r];
                        });
  copy_async_wait();
  if (cl > 1) {
    exchange_partials(Pown, slot_bytes, cb == 0 ? (kClusterF - 1) * slot_bytes : 0,
                      &full_bar, iters & 1, cb, tid, 0);
  } else {
    __syncthreads();
  }
  if (cb == 0) {
    // r_dual: Ps x + q + As' y
    prod_k(X, [&](int, int rg, int k, const VT (&acc)[R]) {
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                              const int row = row0 + rg * R + r;
                              const VT* pp = (cl > 1 ? P : Rb) + k * RC + rg * R + r;
                              VT t = pp[0];
                              if (cl > 1) {
#pragma unroll
                                for (int c = 1; c < kClusterF; ++c) t += pp[(size_t)c * slot];
                              }
                              t += acc[r] + affine(q0, Mq, k, theta + (size_t)row * nt, nt,
                                                   row < B);
                              atomicMax(rd_bits + rg * R + r, abs_bits((float)t));
                            }
                          });
  }

  // ---- the final iterate out: x from the first block, y and z by slice
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = tid + j * kThreadsF;
    if (cb == 0 && u < RG * n) {
      const int rg = u >= n, k = u - rg * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rg * R + r;
        if (row < B) x_out[(size_t)row * n + k] = x[j][r];
      }
    }
    if (u < RG * msc) {
      const int rg = u >= msc, i = s0 + u - rg * msc;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rg * R + r;
        if (row < B) {
          y_out[(size_t)row * m + i] = y[j][r];
          z_out[(size_t)row * m + i] = z[j][r];
        }
      }
    }
  }
  // the other blocks' maxima are in; no block leaves while its shared
  // memory is in use
  if (cl > 1) cg::this_cluster().sync();
  else __syncthreads();
  if (cb == 0 && tid < RC && row0 + tid < B) {
    r_prim[row0 + tid] = __int_as_float(rp_bits[tid]);
    r_dual[row0 + tid] = __int_as_float(rd_bits[tid]);
  }
}

template <int RC>
cudaError_t launch_factored(RTMPC_FAC_PARAMS, cudaStream_t stream) {
  auto kernel = admm_kernel_factored<RC>;
  const int cl = fac_cl(n, m);
  const size_t smem = fac_layout(cl, RC, n, m).floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + RC - 1) / RC) * cl);
  cfg.blockDim = dim3(kThreadsF);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, RTMPC_FAC_ARGS);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of admm_kernel_factored<4> that the current device holds at once
// at (n, m), from the occupancy API, or 0 if it cannot say.
int clusters_in_flight(int n, int m) {
  auto kernel = admm_kernel_factored<4>;
  const size_t smem = fac_layout(kClusterF, 4, n, m).floats * sizeof(float);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterF);
  cfg.blockDim = dim3(kThreadsF);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterF;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int num = 0;
  return cudaOccupancyMaxActiveClusters(&num, kernel, &cfg) == cudaSuccess ? num : 0;
}

// Rows a group at (B, n, m): one row on one block (B <= 64 there) and up to
// kFacOneRowB rows on a cluster (the float64 path; a pure function of (B,
// n, m), so that the plain version can follow it), else the fewer of 4 and
// 16 with which the batch runs in one wave of the groups the device holds
// at once (the occupancy API, asked once a device and shape), else 16.
int fac_rows(int B, int n, int m) {
  if (B <= kFacOneRowB || fac_cl(n, m) == 1) return 1;
  struct Entry { int dev, n, m, g4; };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  int g4 = -1;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used && i < 64; ++i) {
      if (cache[i].dev == dev && cache[i].n == n && cache[i].m == m) g4 = cache[i].g4;
    }
  }
  if (g4 < 0) {
    g4 = clusters_in_flight(n, m);
    std::lock_guard<std::mutex> lock(mu);
    cache[used % 64] = Entry{dev, n, m, g4};
    ++used;
  }
  return (B + 3) / 4 <= g4 ? 4 : 16;
}

}  // namespace

// Whether the "fac" path takes a QP of n variables and m rows: no block of a
// cluster would own fewer than no rows of As (m >= 7 ceil(m / 8): the
// kernel does not clamp the block slices, since clamping them made ptxas
// spill registers in the 16-row instance, which then ran slower), its
// layout fits a block's shared memory at every rows a
// group it may run (one block: one row; a cluster: 1, 4 or 16), and n is at
// most 256 (the state's registers; implied by the fit: Kinv alone passes
// 227 KB above about 238).  A pure function of (n, m); qp_cuda._fac_fits
// mirrors it.
bool factored_fits(int n, int m) {
  if (n > kMaxSliceF) return false;
  const int cl = fac_cl(n, m);
  if (m < (cl - 1) * ((m + cl - 1) / cl)) return false;
  if (cl == 1) return fac_fits_rc(1, 1, n, m);
  return fac_fits_rc(cl, 1, n, m) && fac_fits_rc(cl, 4, n, m) && fac_fits_rc(cl, 16, n, m);
}

// The "fac" path on the calling thread's current device (admm_kernel.cu's
// dispatch calls it where factored_fits holds).  Returns cudaGetLastError()
// of the launch.
int factored_solve_on_current_device(RTMPC_FAC_PARAMS, cudaStream_t stream) {
  switch (fac_rows(B, n, m)) {
    case 1: return (int)launch_factored<1>(RTMPC_FAC_ARGS, stream);
    case 4: return (int)launch_factored<4>(RTMPC_FAC_ARGS, stream);
    default: return (int)launch_factored<16>(RTMPC_FAC_ARGS, stream);
  }
}

// Batch rows a group (block or cluster) of the "fac" path owns at (B, n, m)
// on the current device.
int factored_rows_per_group(int B, int n, int m) { return fac_rows(B, n, m); }
