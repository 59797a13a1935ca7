// The bending optimiser: Adam steps on polylines under the continuous
// travel-time functional, one block a path, every step in one launch.
//
// A kernel of the port's own choice: the JAX package runs the bend as
// XLA, optax.adam inside a lax.scan vmapped over the paths
// (raytracer_tpu/solvers/refine.py _bend_scan_jit, _bend_init_jit,
// _bend_final_jit), with no Pallas kernel.  Python wrapper and plain
// PyTorch twin (the functional, autograd and optax's Adam written out):
// raytracer_tpu_torch/ops/bend.py (bend, bend_reference).
//
// What it computes.  P, mu, nu, bestP (B, m, D) and bestT (B) of type T
// (float or double, one template build a type; D = 2 or 3), in place.
// The functional of a path: t = sum_j L_j * (1/quad) sum_k s(r_jk), with
// e = P[j+1] - P[j], L = sqrt(|e|^2 + eps), p_k = P[j] + e ts[k],
// r = sqrt(|p|^2 + eps), eps = 1e-18, y = (r - r0) inv_dr,
// x = clip(y, 0, n-1), i = clip(int(x), 0, n-2), f = x - i,
// s = tab[i] (1 - f) + tab[i+1] f.  Its gradient, segment by segment, is
// what the twin's autograd takes:
//   dt/dP[j]   = -e mean_s / L + (L/quad) sum_k c_k p_k (1 - ts[k]),
//   dt/dP[j+1] =  e mean_s / L + (L/quad) sum_k c_k p_k ts[k],
//   c_k = (tab[i+1] - tab[i]) inv_dr / r_k where 0 <= y_k <= n-1 (torch's
//   clamp passes its gradient at both edges), else 0;
// a vertex sums its two segments' terms.  The steps, as the twin's:
//   (init)  best = t(P), bestP = P;
//   step:   t, g = t(P), dt/dP; where t < best (False for a NaN t), bestP
//           = P and best = t; g *= free (0 at the two endpoints);
//           mu = (1-b1) g + b1 mu; nu = (1-b2) g g + b2 nu; count += 1;
//           u = -lr (mu/(1-b1^count)) / (sqrt(nu/(1-b2^count)) + 1e-8);
//           P += u free; then P *= r_max/|P| where |P| > r_max (every
//           vertex, the endpoints too);
//   (final) where t(P) < best, bestP = P and best = t(P).
// Every product, sum and difference is one correctly rounded operation
// (no contraction into FMAs); the sums over a segment's quadrature
// points and over the segments run in another order than the twin's, so
// the floats agree to rounding, not bit for bit.  The Adam count enters
// as count0, so a bend cut into launches is the same bend.
//
// Layout.  Block b holds path b; its iterate, best iterate, Adam moments
// and the segments' gradient terms sit in dynamic shared memory
// (4 m D + 2 (m-1) D values: 58.7 KB at m = 384, D = 3 in double).  A
// step: each thread evaluates the segments j = tid, tid + 128, ...
// (quad points in a loop) into shared memory and sums its share of t; a
// warp-shuffle tree and the warps' partial sums in a fixed order give t
// to every thread; then each thread updates the vertices v = tid, tid +
// 128, ... (best copy, Adam, free mask, projection); two barriers a step.
//
// What bounds it on an H100.  The work is arithmetic on data that never
// leaves the SM: ~40 floating-point operations a quadrature point, so a
// step of a 128-vertex path at quad 8 is ~41k operations, and the bytes
// (the polylines in and out) are read once.  Per block the steps are
// strictly sequential, each a chain of dependent loads, square roots and
// barriers, so one block keeps one SM only partly busy: the launch is
// latency-bound.  With B >= 132 paths every SM has work; a batch of 150
// paths puts 18 SMs to two blocks.  The simple design stands (no
// wgmma, no TMA: there is no matrix product here).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::mul_rn;
using minplus::sub_rn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr double kEps = 1e-18;
constexpr double kB1 = 0.9;
constexpr double kB2 = 0.999;
constexpr double kAdamEps = 1e-8;

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
struct Prof {
  const T* tab;
  int n;
  T r0;
  T inv_dr;
};

// t of segment (a, b) and, when gA is given, its gradient with respect to
// both endpoints
template <typename T, int D>
__device__ T segment(const T* a, const T* b, const T* ts, int quad, const Prof<T>& pf, T* gA,
                     T* gB) {
  T e[D];
  T L2 = T(0);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    e[c] = sub_rn(b[c], a[c]);
    L2 = c == 0 ? mul_rn(e[c], e[c]) : add_rn(L2, mul_rn(e[c], e[c]));
  }
  const T L = sqrt(add_rn(L2, T(kEps)));
  const T top = T(pf.n - 1);
  T ssum = T(0);
  T qa[D], qb[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qa[c] = qb[c] = T(0);
  for (int k = 0; k < quad; ++k) {
    const T tk = ts[k];
    T p[D];
    T rr = T(0);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      p[c] = add_rn(a[c], mul_rn(e[c], tk));
      rr = c == 0 ? mul_rn(p[c], p[c]) : add_rn(rr, mul_rn(p[c], p[c]));
    }
    const T r = sqrt(add_rn(rr, T(kEps)));
    const T y = mul_rn(sub_rn(r, pf.r0), pf.inv_dr);
    // torch.clamp: NaN stays NaN (fmin/fmax would drop it)
    const T x = isnan(y) ? y : (y < T(0) ? T(0) : (y > top ? top : y));
    int i = static_cast<int>(x);
    i = i < 0 ? 0 : (i > pf.n - 2 ? pf.n - 2 : i);
    const T f = sub_rn(x, static_cast<T>(i));
    const T t0 = pf.tab[i], t1 = pf.tab[i + 1];
    ssum = add_rn(ssum, add_rn(mul_rn(t0, sub_rn(T(1), f)), mul_rn(t1, f)));
    if (gA) {
      const bool inside = y >= T(0) && y <= top;
      const T ck = inside ? div_rn(mul_rn(sub_rn(t1, t0), pf.inv_dr), r) : T(0);
      const T wa = mul_rn(ck, sub_rn(T(1), tk)), wb = mul_rn(ck, tk);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        qa[c] = add_rn(qa[c], mul_rn(wa, p[c]));
        qb[c] = add_rn(qb[c], mul_rn(wb, p[c]));
      }
    }
  }
  const T mean = div_rn(ssum, static_cast<T>(quad));
  if (gA) {
    const T coef = div_rn(mean, L);
    const T h = div_rn(L, static_cast<T>(quad));
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const T le = mul_rn(e[c], coef);
      gA[c] = add_rn(-le, mul_rn(h, qa[c]));
      gB[c] = add_rn(le, mul_rn(h, qb[c]));
    }
  }
  return mul_rn(L, mean);
}

// the sum of every thread's `v` in a fixed order, returned to all
template <typename T>
__device__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  T s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = add_rn(s, red[w]);
  __syncthreads();
  return s;
}

// t of the path in shared memory; with gA/gB, the segments' gradient
// terms too
template <typename T, int D>
__device__ T path_time(const T* P, int m, const T* ts, int quad, const Prof<T>& pf, T* gA, T* gB,
                       T* red) {
  T part = T(0);
  for (int j = threadIdx.x; j < m - 1; j += kThreads)
    part = add_rn(part, segment<T, D>(P + j * D, P + (j + 1) * D, ts, quad, pf,
                                      gA ? gA + j * D : nullptr, gB ? gB + j * D : nullptr));
  return block_sum(part, red);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bend_kernel(T* __restrict__ gP, T* __restrict__ gmu, T* __restrict__ gnu,
                T* __restrict__ gbestP, T* __restrict__ gbestT, const T* __restrict__ gts,
                Prof<T> pf, T lr, T r_max, int count0, int iters, int quad, int m, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int md = m * D;
  T* P = sm;
  T* bestP = P + md;
  T* mu = bestP + md;
  T* nu = mu + md;
  T* gA = nu + md;
  T* gB = gA + (m - 1) * D;
  T* ts = gB + (m - 1) * D;
  T* red = ts + quad;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * md;
  for (int i = threadIdx.x; i < md; i += kThreads) {
    P[i] = gP[base + i];
    mu[i] = gmu[base + i];
    nu[i] = gnu[base + i];
    bestP[i] = gbestP[base + i];
  }
  for (int k = threadIdx.x; k < quad; k += kThreads) ts[k] = gts[k];
  __syncthreads();

  T best;
  if (flags & 1) {
    best = path_time<T, D>(P, m, ts, quad, pf, nullptr, nullptr, red);
    for (int i = threadIdx.x; i < md; i += kThreads) bestP[i] = P[i];
  } else {
    best = gbestT[blockIdx.x];
  }

  const T c1 = T(1.0 - kB1), c2 = T(1.0 - kB2);
  const T b1 = T(kB1), b2 = T(kB2), aeps = T(kAdamEps), neg_lr = -lr;
  for (int step = 0; step < iters; ++step) {
    const T t = path_time<T, D>(P, m, ts, quad, pf, gA, gB, red);
    const bool better = t < best;
    if (better) best = t;
    const int count = count0 + step + 1;
    const T bc1 = T(1.0 - pow(kB1, static_cast<double>(count)));
    const T bc2 = T(1.0 - pow(kB2, static_cast<double>(count)));
    for (int v = threadIdx.x; v < m; v += kThreads) {
      const T fr = (v == 0 || v == m - 1) ? T(0) : T(1);
      T q[D];
      T rr = T(0);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const int i = v * D + c;
        if (better) bestP[i] = P[i];
        T g = T(0);
        if (v < m - 1) g = gA[i];
        if (v > 0) g = add_rn(g, gB[i - D]);
        g = mul_rn(g, fr);
        const T mv = add_rn(mul_rn(c1, g), mul_rn(b1, mu[i]));
        const T nv = add_rn(mul_rn(c2, mul_rn(g, g)), mul_rn(b2, nu[i]));
        mu[i] = mv;
        nu[i] = nv;
        const T mh = div_rn(mv, bc1), nh = div_rn(nv, bc2);
        const T u = mul_rn(neg_lr, div_rn(mh, add_rn(sqrt(nh), aeps)));
        q[c] = add_rn(P[i], mul_rn(u, fr));
        rr = c == 0 ? mul_rn(q[c], q[c]) : add_rn(rr, mul_rn(q[c], q[c]));
      }
      const T r = sqrt(rr);
      const bool out = r > r_max;
      const T sc = out ? div_rn(r_max, r) : T(1);
#pragma unroll
      for (int c = 0; c < D; ++c) P[v * D + c] = out ? mul_rn(q[c], sc) : q[c];
    }
    __syncthreads();
  }

  if (flags & 2) {
    const T tF = path_time<T, D>(P, m, ts, quad, pf, nullptr, nullptr, red);
    if (tF < best) {
      best = tF;
      for (int i = threadIdx.x; i < md; i += kThreads) bestP[i] = P[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < md; i += kThreads) {
    gP[base + i] = P[i];
    gmu[base + i] = mu[i];
    gnu[base + i] = nu[i];
    gbestP[base + i] = bestP[i];
  }
  if (threadIdx.x == 0) gbestT[blockIdx.x] = best;
}

template <typename T, int D>
int launch(void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
           const void* tab, int n_tab, double r0, double inv_dr, double lr, double r_max,
           int count0, int iters, int quad, int B, int m, int flags, cudaStream_t st) {
  const size_t smem =
      sizeof(T) * (4 * static_cast<size_t>(m) * D + 2 * static_cast<size_t>(m - 1) * D + quad +
                   kWarps + 2);
  if (smem > minplus::kBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(bend_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Prof<T> pf{static_cast<const T*>(tab), n_tab, static_cast<T>(r0), static_cast<T>(inv_dr)};
  bend_kernel<T, D><<<B, kThreads, smem, st>>>(
      static_cast<T*>(P), static_cast<T*>(mu), static_cast<T*>(nu), static_cast<T*>(bestP),
      static_cast<T*>(bestT), static_cast<const T*>(ts), pf, static_cast<T>(lr),
      static_cast<T>(r_max), count0, iters, quad, m, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
             const void* tab, int n_tab, double r0, double inv_dr, double lr, double r_max,
             int count0, int iters, int quad, int B, int m, int flags, cudaStream_t st) {
  return d == 2 ? launch<T, 2>(P, mu, nu, bestP, bestT, ts, tab, n_tab, r0, inv_dr, lr, r_max,
                               count0, iters, quad, B, m, flags, st)
                : launch<T, 3>(P, mu, nu, bestP, bestT, ts, tab, n_tab, r0, inv_dr, lr, r_max,
                               count0, iters, quad, B, m, flags, st);
}

}  // namespace

// Launches [the initial evaluation,] `iters` Adam steps [and the final
// selection] of B paths on `stream`; returns the CUDA error as an int (0
// when the launch was accepted).  P, mu, nu, bestP (B, m, d) and bestT
// (B) float32, or float64 when is_double, updated in place (bestP and
// bestT are written by the initial evaluation when flags & 1, read
// otherwise); ts (quad) the quadrature points and tab (n_tab) the
// uniform slowness table, of the same type; r0, inv_dr, lr and r_max are
// cast to it.  count0: the Adam steps taken before this launch.  flags:
// 1 = initial evaluation, 2 = final selection.  d is 2 or 3.  All
// contiguous device memory.
extern "C" int bend_launch(void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
                           const void* tab, int n_tab, double r0, double inv_dr, double lr,
                           double r_max, int count0, int iters, int quad, int B, int m, int d,
                           int flags, int is_double, void* stream) {
  if (!P || !mu || !nu || !bestP || !bestT || !ts || !tab || n_tab < 2 || count0 < 0 ||
      iters < 0 || quad < 1 || B < 0 || m < 2 || (d != 2 && d != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_d<double>(d, P, mu, nu, bestP, bestT, ts, tab, n_tab, r0, inv_dr, lr,
                                      r_max, count0, iters, quad, B, m, flags, st)
                   : launch_d<float>(d, P, mu, nu, bestP, bestT, ts, tab, n_tab, r0, inv_dr, lr,
                                     r_max, count0, iters, quad, B, m, flags, st);
}
