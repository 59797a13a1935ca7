// The bending optimiser: Adam steps on polylines under the continuous
// travel-time functional, one block a path, every step in one launch.
//
// A kernel of the port's own choice: the JAX package runs the bend as
// XLA, optax.adam inside a lax.scan vmapped over the paths
// (raytracer_tpu/solvers/refine.py _bend_scan_jit, _bend_init_jit,
// _bend_final_jit), with no Pallas kernel.  Python wrapper, planner and
// plain PyTorch twin (the functional, autograd and optax's Adam written
// out): raytracer_tpu_torch/ops/bend.py (bend, bend_plan,
// bend_reference).
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
//           u = -lr (mu/bc1[count]) / (sqrt(nu/bc2[count]) + 1e-8);
//           P += u free; then P *= r_max/|P| where |P| > r_max (every
//           vertex, the endpoints too);
//   (final) where t(P) < best, bestP = P and best = t(P).
// The bias corrections bc1 = 1 - b1^count and bc2 = 1 - b2^count come
// from the host (the wrapper's `bias_table`: Python's own float power, in
// double, cast to T, as the twin computes them), one pair a step of the
// launch, so a bend cut into launches is the same bend bit for bit.
// Every product, sum and difference is one correctly rounded operation
// (no contraction into FMAs), the divisions and square roots within one
// ulp (`quot`, `root`); the sums over a segment's quadrature points and
// over the segments run in another order than the twin's (below), so the
// floats agree to rounding, not bit for bit.
//
// Layout.  Block b holds path b, with `threads` threads (a multiple of 32,
// up to 1,024) chosen by the wrapper's planner from the batch, the path
// and the card.  Its iterate, best iterate, Adam moments and the
// segments' gradient terms sit in dynamic shared memory (4 m D +
// 2 (m-1) D values: 58.7 KB at m = 384, D = 3 in double) with the
// quadrature points, the warps' partial times and a window of
// kBiasWindow steps of bias corrections.  A step:
//   * eval: the segments go to groups of `lanes` lanes (a power of 2 up
//     to 32), segment j = pass * (threads/lanes) + group; lane l of a
//     group takes the segment's quadrature points k = l, l + lanes, ...
//     in order (unrolled by 4, by 2 in double where 64 registers hold no
//     more, so the points' chains overlap and only their sums wait on
//     each other), then the group sums its lanes'
//     partials (the point sum
//     and the 2 D gradient sums) by xor shuffles at distances 1, 2, 4,
//     ..., so every lane holds the same sums; lane 0 writes the segment's
//     two gradient terms; each thread adds its segments' times in pass
//     order, the warp sums them by xor shuffles at distances lanes, 2
//     lanes, ..., 16, and lane 0 writes the warp's partial;
//   * one barrier; every warp sums the warps' partials (zero-padded to a
//     power of 2) by xor shuffles at distances 1, 2, ... (the path's t,
//     the same bits in every thread), and thread v updates the
//     vertices v, v + threads, ... (best copy, Adam, free mask,
//     projection);
//   * one barrier.
// Two barriers a step (the eval's results and the new iterate).
//
// What bounds it on an H100.  The work is arithmetic on data that never
// leaves the SM: ~40 floating-point operations a quadrature point, so a
// step of a 128-vertex path at quad 8 is ~41k operations, and the bytes
// (the polylines in and out) are read once.  Per block the steps are
// strictly sequential, so a batch of about the SM count is latency-bound:
// a step costs its longest chain (a lane's quadrature points, the
// shuffles, the sums of t, the Adam update's divisions and square roots)
// and two barriers.  Spreading a segment's points over lanes cuts that
// chain from quad points to quad/lanes, at the price of shuffles and of
// more warps to sum and to wait for; the planner (ops/bend.py bend_plan)
// weighs the two and the waves of blocks (1,024 threads an SM:
// __launch_bounds__ caps the registers at 64) with costs set from the
// card's times: the --refine fan takes a thread a segment in float32 and
// 2 lanes a segment in float64.  The one-ulp divisions and square roots
// (`quot`, `root`) took a third off the step against IEEE's.  A batch of
// thousands of paths in double (the travel-time tables) is bound by the
// float64 issue rate instead (a lane's points), which the planner's
// 256-thread blocks, four an SM, keep fed.  The simple design stands (no
// wgmma, no TMA: there is no matrix product here); the slowness table is
// read through L1 (51 KB in double): staged in shared memory it ran no
// faster on the fan and 24 % slower on the tables' sub-batch (fewer
// blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::mul_rn;
using minplus::sub_rn;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBiasWindow = 64;
constexpr double kEps = 1e-18;
constexpr double kB1 = 0.9;
constexpr double kB2 = 0.999;
constexpr double kAdamEps = 1e-8;
constexpr unsigned kFull = 0xffffffffu;

// a / b and sqrt(x) within one ulp, almost always the correctly rounded
// value: the hardware's approximate reciprocal (reciprocal square root),
// refined by Newton steps, and the result corrected by its exact
// residual (an FMA), with no branch, so a lane's quadrature points
// overlap.  IEEE's __fdiv_rn / sqrt took about half of a step on the card
// (their range checks and slow paths sit on the step's chain).  The
// divisors here are never 0 (a radius or length under a 1e-18 floor, a
// bias correction, the Adam denominator); sqrt(0) is 0, sqrt(inf) inf
// and a NaN stays one.  Only a subnormal square (a second moment below
// 1e-38, under the Adam denominator's 1e-8) loses digits, which the
// denominator's 1e-8 then swamps.
__device__ __forceinline__ float recip(float b) {
  const float y = __fdividef(1.0f, b);
  return fmaf(fmaf(-b, y, 1.0f), y, y);
}
__device__ __forceinline__ double recip(double b) {
  double y = static_cast<double>(__fdividef(1.0f, static_cast<float>(b)));
  y = fma(fma(-b, y, 1.0), y, y);
  return fma(fma(-b, y, 1.0), y, y);
}
template <typename T>
__device__ __forceinline__ T quot(T a, T b) {
  const T y = recip(b);
  const T q = mul_rn(a, y);
  return fma(fma(-q, b, a), y, q);
}
constexpr float kFloatMin = 1.17549435e-38f;
__device__ __forceinline__ float root(float x) {
  const float y = rsqrtf(fmaxf(x, kFloatMin));
  const float s = __fmul_rn(x, y);
  const float r = fmaf(fmaf(-s, s, x), __fmul_rn(0.5f, y), s);
  return isinf(x) ? x : r;
}
__device__ __forceinline__ double root(double x) {
  double y = static_cast<double>(rsqrtf(fmaxf(static_cast<float>(x), kFloatMin)));
  y = fma(fma(-0.5 * x * y, y, 0.5), y, y);
  y = fma(fma(-0.5 * x * y, y, 0.5), y, y);
  const double s = __dmul_rn(x, y);
  const double r = fma(fma(-s, s, x), __dmul_rn(0.5, y), s);
  return isinf(x) ? x : r;
}

template <typename T>
struct Prof {
  const T* tab;
  int n;
  T r0;
  T inv_dr;
};

// one lane's share of segment (a, b): its points k = lane, lane + lanes,
// ... summed in that order into ssum and, with GRAD, qa and qb
template <typename T, int D, bool GRAD>
__device__ __forceinline__ void lane_part(const T* a, const T* e, const T* ts, int quad, int lane,
                                          int lanes, const Prof<T>& pf, T& ssum, T* qa, T* qb) {
  const T top = T(pf.n - 1);
  ssum = T(0);
#pragma unroll
  for (int c = 0; c < D; ++c) qa[c] = qb[c] = T(0);
#pragma unroll (sizeof(T) == 4 ? 4 : 2)
  for (int k = lane; k < quad; k += lanes) {
    const T tk = ts[k];
    T p[D];
    T rr = T(0);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      p[c] = add_rn(a[c], mul_rn(e[c], tk));
      rr = c == 0 ? mul_rn(p[c], p[c]) : add_rn(rr, mul_rn(p[c], p[c]));
    }
    const T r = root(add_rn(rr, T(kEps)));
    const T y = mul_rn(sub_rn(r, pf.r0), pf.inv_dr);
    // torch.clamp: NaN stays NaN (fmin/fmax would drop it)
    const T x = isnan(y) ? y : (y < T(0) ? T(0) : (y > top ? top : y));
    int i = static_cast<int>(x);
    i = i < 0 ? 0 : (i > pf.n - 2 ? pf.n - 2 : i);
    const T f = sub_rn(x, static_cast<T>(i));
    const T t0 = pf.tab[i], t1 = pf.tab[i + 1];
    ssum = add_rn(ssum, add_rn(mul_rn(t0, sub_rn(T(1), f)), mul_rn(t1, f)));
    if (GRAD) {
      const bool inside = y >= T(0) && y <= top;
      const T ck = inside ? quot(mul_rn(sub_rn(t1, t0), pf.inv_dr), r) : T(0);
      const T wa = mul_rn(ck, sub_rn(T(1), tk)), wb = mul_rn(ck, tk);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        qa[c] = add_rn(qa[c], mul_rn(wa, p[c]));
        qb[c] = add_rn(qb[c], mul_rn(wb, p[c]));
      }
    }
  }
}

// v / quad: a product where quad is a power of 2 (the same bits: 1/quad
// is exact), else the division
template <typename T>
__device__ __forceinline__ T by_quad(T v, int quad) {
  return (quad & (quad - 1)) == 0 ? mul_rn(v, T(1) / static_cast<T>(quad))
                                  : quot(v, static_cast<T>(quad));
}

// xor-shuffle sum over the aligned groups of `width` lanes, distances 1,
// 2, 4, ... < width (every lane ends with the same bits: a + b == b + a)
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int o = 1; o < width; o <<= 1) v = add_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// t of the path in shared memory (every thread gets the same bits); with
// GRAD the segments' gradient terms gA, gB too.  One barrier, after the
// warps' partials are written: the caller must not let a thread write
// `red` again before every thread has read it (a later barrier).
template <typename T, int D, bool GRAD>
__device__ T path_time(const T* P, int m, const T* ts, int quad, int lanes, const Prof<T>& pf,
                       T* gA, T* gB, T* red) {
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x >> (__ffs(lanes) - 1);
  const int groups = blockDim.x >> (__ffs(lanes) - 1);
  T tpart = T(0);
  for (int j0 = 0; j0 < m - 1; j0 += groups) {
    const int j = j0 + group;
    const bool valid = j < m - 1;
    const T* a = P + (valid ? j : m - 2) * D;
    T e[D];
    T L2 = T(0);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      e[c] = sub_rn(a[D + c], a[c]);
      L2 = c == 0 ? mul_rn(e[c], e[c]) : add_rn(L2, mul_rn(e[c], e[c]));
    }
    T ssum, qa[D], qb[D];
    lane_part<T, D, GRAD>(a, e, ts, quad, lane, lanes, pf, ssum, qa, qb);
    ssum = group_sum(ssum, lanes);
    if (GRAD) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        qa[c] = group_sum(qa[c], lanes);
        qb[c] = group_sum(qb[c], lanes);
      }
    }
    if (valid) {
      const T L = root(add_rn(L2, T(kEps)));
      const T mean = by_quad(ssum, quad);
      tpart = add_rn(tpart, mul_rn(L, mean));
      if (GRAD && lane == 0) {
        const T coef = quot(mean, L);
        const T h = by_quad(L, quad);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const T le = mul_rn(e[c], coef);
          gA[j * D + c] = add_rn(-le, mul_rn(h, qa[c]));
          gB[j * D + c] = add_rn(le, mul_rn(h, qb[c]));
        }
      }
    }
  }
  for (int o = lanes; o < 32; o <<= 1) tpart = add_rn(tpart, __shfl_xor_sync(kFull, tpart, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = tpart;
  __syncthreads();
  // the warps' partials, padded with zeros to a power of 2, summed by
  // xor shuffles in every warp alike
  const int warps = blockDim.x >> 5;
  int p2 = 1;
  while (p2 < warps) p2 <<= 1;
  const int w = threadIdx.x & (p2 - 1);
  T t = w < warps ? red[w] : T(0);
  for (int o = 1; o < p2; o <<= 1) t = add_rn(t, __shfl_xor_sync(kFull, t, o));
  return t;
}

// the next kBiasWindow steps' bias corrections (steps s0 ...) into the
// window: win[0..W) = bc1, win[W..2W) = bc2
template <typename T>
__device__ __forceinline__ void stage_bias(T* win, const T* bias, int s0, int iters) {
  for (int i = threadIdx.x; i < 2 * kBiasWindow; i += blockDim.x) {
    const int which = i / kBiasWindow, s = s0 + i % kBiasWindow;
    if (s < iters) win[i] = bias[which * iters + s];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    bend_kernel(T* __restrict__ gP, T* __restrict__ gmu, T* __restrict__ gnu,
                T* __restrict__ gbestP, T* __restrict__ gbestT, const T* __restrict__ gts,
                const T* __restrict__ bias, Prof<T> pf, T lr, T r_max, int iters, int quad,
                int m, int lanes, int flags) {
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
  T* win = red + kMaxWarps;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * md;
  for (int i = threadIdx.x; i < md; i += blockDim.x) {
    P[i] = gP[base + i];
    mu[i] = gmu[base + i];
    nu[i] = gnu[base + i];
    bestP[i] = gbestP[base + i];
  }
  for (int k = threadIdx.x; k < quad; k += blockDim.x) ts[k] = gts[k];
  __syncthreads();

  T best;
  if (flags & 1) {
    best = path_time<T, D, false>(P, m, ts, quad, lanes, pf, nullptr, nullptr, red);
    for (int i = threadIdx.x; i < md; i += blockDim.x) bestP[i] = P[i];
  } else {
    best = gbestT[blockIdx.x];
  }
  __syncthreads();

  const T c1 = T(1.0 - kB1), c2 = T(1.0 - kB2);
  const T b1 = T(kB1), b2 = T(kB2), aeps = T(kAdamEps), neg_lr = -lr;
  for (int step = 0; step < iters; ++step) {
    // the window is read after this step's first barrier and was last
    // read before the previous step's second
    if (step % kBiasWindow == 0) stage_bias(win, bias, step, iters);
    const T t = path_time<T, D, true>(P, m, ts, quad, lanes, pf, gA, gB, red);
    const bool better = t < best;
    if (better) best = t;
    const T bc1 = win[step % kBiasWindow], bc2 = win[kBiasWindow + step % kBiasWindow];
    for (int v = threadIdx.x; v < m; v += blockDim.x) {
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
        const T mh = quot(mv, bc1), nh = quot(nv, bc2);
        const T u = mul_rn(neg_lr, quot(mh, add_rn(root(nh), aeps)));
        q[c] = add_rn(P[i], mul_rn(u, fr));
        rr = c == 0 ? mul_rn(q[c], q[c]) : add_rn(rr, mul_rn(q[c], q[c]));
      }
      const T r = root(rr);
      const bool out = r > r_max;
      const T sc = out ? quot(r_max, r) : T(1);
#pragma unroll
      for (int c = 0; c < D; ++c) P[v * D + c] = out ? mul_rn(q[c], sc) : q[c];
    }
    __syncthreads();
  }

  if (flags & 2) {
    const T tF = path_time<T, D, false>(P, m, ts, quad, lanes, pf, nullptr, nullptr, red);
    if (tF < best) {
      best = tF;
      for (int i = threadIdx.x; i < md; i += blockDim.x) bestP[i] = P[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < md; i += blockDim.x) {
    gP[base + i] = P[i];
    gmu[base + i] = mu[i];
    gnu[base + i] = nu[i];
    gbestP[base + i] = bestP[i];
  }
  if (threadIdx.x == 0) gbestT[blockIdx.x] = best;
}

// the dynamic shared memory of one block (ops/bend.py smem_bytes)
size_t smem_bytes(int m, int d, int quad, size_t itemsize) {
  return itemsize * (4 * static_cast<size_t>(m) * d + 2 * static_cast<size_t>(m - 1) * d + quad +
                     kMaxWarps + 2 * kBiasWindow);
}

template <typename T, int D>
int launch(void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
           const void* bias, const void* tab, int n_tab, double r0, double inv_dr, double lr,
           double r_max, int iters, int quad, int B, int m, int threads, int lanes, int flags,
           cudaStream_t st) {
  const size_t smem = smem_bytes(m, D, quad, sizeof(T));
  if (smem > minplus::kBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(bend_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Prof<T> pf{static_cast<const T*>(tab), n_tab, static_cast<T>(r0), static_cast<T>(inv_dr)};
  bend_kernel<T, D><<<B, threads, smem, st>>>(
      static_cast<T*>(P), static_cast<T*>(mu), static_cast<T*>(nu), static_cast<T*>(bestP),
      static_cast<T*>(bestT), static_cast<const T*>(ts), static_cast<const T*>(bias), pf,
      static_cast<T>(lr), static_cast<T>(r_max), iters, quad, m, lanes, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
             const void* bias, const void* tab, int n_tab, double r0, double inv_dr, double lr,
             double r_max, int iters, int quad, int B, int m, int threads, int lanes, int flags,
             cudaStream_t st) {
  return d == 2 ? launch<T, 2>(P, mu, nu, bestP, bestT, ts, bias, tab, n_tab, r0, inv_dr, lr,
                               r_max, iters, quad, B, m, threads, lanes, flags, st)
                : launch<T, 3>(P, mu, nu, bestP, bestT, ts, bias, tab, n_tab, r0, inv_dr, lr,
                               r_max, iters, quad, B, m, threads, lanes, flags, st);
}

}  // namespace

// Launches [the initial evaluation,] `iters` Adam steps [and the final
// selection] of B paths on `stream`; returns the CUDA error as an int (0
// when the launch was accepted).  P, mu, nu, bestP (B, m, d) and bestT
// (B) float32, or float64 when is_double, updated in place (bestP and
// bestT are written by the initial evaluation when flags & 1, read
// otherwise); ts (quad) the quadrature points, bias (2, iters) the bias
// corrections 1 - 0.9^count and 1 - 0.999^count of the launch's steps
// (count = the steps taken before it + 1, + 2, ...) and tab (n_tab) the
// uniform slowness table, all of the same type; r0, inv_dr, lr and r_max
// are cast to it.  threads: a block's threads (a multiple of 32 up to
// 1,024); lanes: the lanes a segment (1, 2, 4, 8, 16 or 32).  flags:
// 1 = initial evaluation, 2 = final selection.  d is 2 or 3.  All
// contiguous device memory.
extern "C" int bend_launch(void* P, void* mu, void* nu, void* bestP, void* bestT, const void* ts,
                           const void* bias, const void* tab, int n_tab, double r0,
                           double inv_dr, double lr, double r_max, int iters, int quad, int B,
                           int m, int d, int threads, int lanes, int flags, int is_double,
                           void* stream) {
  if (!P || !mu || !nu || !bestP || !bestT || !ts || !tab || n_tab < 2 || iters < 0 ||
      (iters > 0 && !bias) || quad < 1 || B < 0 || m < 2 || (d != 2 && d != 3) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_d<double>(d, P, mu, nu, bestP, bestT, ts, bias, tab, n_tab, r0, inv_dr,
                                      lr, r_max, iters, quad, B, m, threads, lanes, flags, st)
                   : launch_d<float>(d, P, mu, nu, bestP, bestT, ts, bias, tab, n_tab, r0, inv_dr,
                                     lr, r_max, iters, quad, B, m, threads, lanes, flags, st);
}
