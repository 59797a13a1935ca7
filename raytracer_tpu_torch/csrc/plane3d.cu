// One directional plane pass of the 3-D sweep engine.
//
// A kernel of the port's own choice: the JAX package runs this pass as
// XLA, a lax.scan over the planes (raytracer_tpu/solvers/solve3d.py
// _plane_sweep3d), with no Pallas kernel.  Python wrapper, tables and
// plain PyTorch twin: raytracer_tpu_torch/ops/plane3d.py (plane_sweep3d,
// scan_sum_trees, plane_sweep3d_reference; plane3d_scan_reference replays
// the scans' levels).
//
// What it computes.  d (S, nA, p0, p1) float32 or float64 (one template
// build a type): the field with the sweep axis first (the wrapper moves
// it there); W (nA, ns, p0, p1) the weights in the same layout.  For the
// planes p in sweep order (nA-1 .. 0 when down, 0 .. nA-1 when up), cur =
// plane p of d, then
//   1. cross taps (s, m, da, db), m >= 1: cur = min(cur, prev_m[a+da,
//      b+db] + W[p, s]), prev_m the output plane p + m*sgn (processed m
//      steps earlier), or before the first planes carry plane m-1-j (j =
//      planes processed so far), or +inf;
//   2. in-plane taps (s, 0, da, db) in the stencil's order, each a Jacobi
//      update of the whole plane: cur = min(cur, cur[a+da, b+db] + W[p, s]);
//   3. the min-plus line scans along plane axis 0, then along plane axis
//      1: cur = min(x, forward scan of x, backward scan of x), x the plane
//      before that axis's scans;
// and output plane p = cur.  A tap whose source leaves the plane is
// skipped: the JAX package's rolls wrap there, and the wrapped candidate
// always meets a +inf weight (the box faces are masked), so the floats
// are the same.  Each candidate is one __fadd_rn / __dadd_rn and min does
// not depend on order.  The scans are _sum_min_scan's recursion (the
// inclusive scan of (sum, min) pairs in jax.lax.associative_scan's
// order): the sums depend only on the costs, so their levels are read
// from trees built once a layout in the field's type (scan_sum_trees: for
// axis 0 (nA, T0, p1), for axis 1 (nA, p0, T1), T = n + n/2 + ... over
// the levels with at least 2 values; the backward trees from the
// reversed costs), and the kernel runs the min component in place, value
// i of level l at line position (i+1) 2^l - 1: up the levels m[p] =
// min(m[p - 2^l] + s_l[2i+1], m[p]) at p = (2i+2) 2^l - 1, down them m[q]
// = min(m[q - 2^l] + s_l[2i], m[q]) at q = (2i+1) 2^l - 1, i >= 1; the
// backward direction on the reversed line (index arithmetic, no copy).
//
// What bounds it on an H100.  At 128x128x64 and star 1 a pass reads the
// field once and writes it once (8.4 MB), reads 17 of the 26 weight
// planes a node (71 MB) and the four scan-cost stacks (16.8 MB): ~0.03
// ms at 3.35 TB/s; its ~30 M adds and minima are 0.5 us at 67 TFLOP/s
// f32.  But the planes depend on each other (plane p's cross taps read
// plane p -/+ 1), the in-plane taps are one Jacobi step after another,
// and each scan level waits on the last: a plane costs ~80 block
// barriers, and one SM runs every instruction of a source's pass.  So
// the design is simple and right, and latency-bound: one block of 1,024
// threads a source marches the planes; the current plane lives in shared
// memory (64 KB in float32, 128 KB in float64 at 16,384 nodes), and as
// many as three planes where they fit in 227 KB (`planes`): with two,
// the in-plane taps ping-pong between them (no copy back a tap); with
// three, an axis's forward and backward scans run in the same level
// steps, which halves the scans' barriers; with one, the second plane
// lives in device memory (one plane a source).  The previous planes are
// read back from the output, which the L2 holds.  While a plane runs, one
// thread asks the L2 for the next plane's input, weight rows and sum
// trees with bulk prefetches (cp.async.bulk.prefetch.L2); each thread
// starts the loads of kG nodes (or scan items) before it takes their
// minima; plane coordinates come from a multiply-high division.  A
// cluster of blocks sharing one plane through distributed shared memory
// is the obvious next step.

#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::min_of;

constexpr int kThreads = 1024;
constexpr int kMaxLevels = 31;
constexpr int kG = 4;                  // nodes (scan items) a thread loads at once

// n / d for 0 <= n < 2^31 by a multiply-high (d >= 1 fixed): shift =
// ceil(log2 d), mul = floor(2^32 (2^shift - d) / d) + 1
struct FastDiv {
  unsigned d, mul, shift;
  __device__ explicit FastDiv(int d_) : d(static_cast<unsigned>(d_)), shift(0) {
    while ((1u << shift) < d) ++shift;
    mul = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

// ask the L2 for [p, p + bytes) (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(static_cast<unsigned>(bytes))
               : "memory");
}

// sum of the level lengths of a line of n values (the tree's length)
__device__ __forceinline__ int tree_len(int n) {
  int t = 0;
  for (int m = n; m >= 2; m >>= 1) t += m;
  return t;
}

// One scan direction in place: its buffer, its tree ((T0, p1) for plane
// axis 0, (p0, T1) for axis 1) and whether it runs over the reversed
// lines.
template <typename T>
struct Dir {
  T* buf;
  const T* tree;
  bool rev;
};

// the scans of `nd` directions (1 or 2) along plane axis `ax` of the
// (p0, p1) plane, each in place in its own buffer, the levels of both
// between the same barriers
template <typename T>
__device__ void scan_levels(const Dir<T>* dirs, int nd, int ax, int p0, int p1) {
  const int n = ax == 0 ? p0 : p1;    // line length
  const int nl = ax == 0 ? p1 : p0;   // lines
  const int tl = tree_len(n);
  const FastDiv by_nl(nl);
  int offs[kMaxLevels], lens[kMaxLevels], L = 0;
  for (int m = n, off = 0; m >= 2; m >>= 1, ++L) {
    offs[L] = off;
    lens[L] = m;
    off += m;
  }
  const auto at = [&](int t, int line, bool rev) {
    const int u = rev ? n - 1 - t : t;
    return ax == 0 ? u * p1 + line : line * p1 + u;
  };
  const auto sum = [&](const T* tree, int k, int line) {
    return ax == 0 ? tree[static_cast<size_t>(k) * p1 + line]
                   : tree[static_cast<size_t>(line) * tl + k];
  };
  // one level: `cnt` pairs a line; pair i updates t = (2(i+i0)+1+up) 2^l - 1
  // from t - 2^l with sum s_l[2(i+i0) + up]
  const auto level = [&](int l, int cnt, int i0, int up) {
    const int items = cnt * nl;
    const FastDiv by_cnt(cnt > 0 ? cnt : 1);
    for (int it0 = threadIdx.x; it0 < items; it0 += kG * blockDim.x) {
      int i[kG], line[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int it = it0 + g * blockDim.x;
        if (ax == 0) {
          i[g] = by_nl.div(it);
          line[g] = it - i[g] * nl;
        } else {
          line[g] = by_cnt.div(it);
          i[g] = it - line[g] * cnt;
        }
        i[g] += i0;
      }
      for (int d = 0; d < nd; ++d) {
        const Dir<T> dr = dirs[d];
        T sv[kG];
        int dst[kG], src[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          dst[g] = -1;
          if (it0 + g * blockDim.x < items) {
            const int t = ((2 * i[g] + 1 + up) << l) - 1;
            dst[g] = at(t, line[g], dr.rev);
            src[g] = at(t - (1 << l), line[g], dr.rev);
            sv[g] = sum(dr.tree, offs[l] + 2 * i[g] + up, line[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (dst[g] >= 0)
            dr.buf[dst[g]] = min_of(add_rn(dr.buf[src[g]], sv[g]), dr.buf[dst[g]]);
      }
    }
    __syncthreads();
  };
  for (int l = 0; l < L; ++l) level(l, lens[l] >> 1, 0, 1);                // up
  for (int l = L - 1; l >= 0; --l) level(l, (lens[l] - 1) >> 1, 1, 0);     // down
}

// cur = min(x, forward scan of x, backward scan of x) along plane axis
// `ax`.  With Y (a third shared plane) both scans run together on copies
// of x in X and Y; else one after the other in cur, X holding x and then
// min(x, forward) (each thread touches only its own nodes of X)
template <typename T>
__device__ void scan_axis(T* cur, T* X, T* Y, const T* tf, const T* tb, int ax, int p0,
                          int p1) {
  const int P = p0 * p1;
  if (Y) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) X[i] = Y[i] = cur[i];
    __syncthreads();
    const Dir<T> dirs[2] = {{X, tf, false}, {Y, tb, true}};
    scan_levels(dirs, 2, ax, p0, p1);
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      cur[i] = min_of(cur[i], min_of(X[i], Y[i]));
    __syncthreads();
    return;
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) X[i] = cur[i];
  __syncthreads();
  const Dir<T> fwd[1] = {{cur, tf, false}}, bwd[1] = {{cur, tb, true}};
  scan_levels(fwd, 1, ax, p0, p1);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const T x = X[i];
    X[i] = min_of(x, cur[i]);
    cur[i] = x;
  }
  __syncthreads();
  scan_levels(bwd, 1, ax, p0, p1);
  for (int i = threadIdx.x; i < P; i += blockDim.x) cur[i] = min_of(X[i], cur[i]);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
plane3d_kernel(const T* __restrict__ din, T* __restrict__ dout, const T* __restrict__ W,
               const T* __restrict__ t0f, const T* __restrict__ t0b,
               const T* __restrict__ t1f, const T* __restrict__ t1b,
               const T* __restrict__ carry, T* xglob, const int* __restrict__ taps,
               int nA, int p0, int p1, int ns, int nc, int n_cross, int n_inpl,
               int down, int planes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = p0 * p1;
  const int s = blockIdx.x;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* X = planes >= 2 ? cur + P : xglob + static_cast<size_t>(s) * P;
  T* Y = planes == 3 ? cur + 2 * P : nullptr;
  const T* in = din + static_cast<size_t>(s) * nA * P;
  T* out = dout + static_cast<size_t>(s) * nA * P;
  const T* car = carry ? carry + static_cast<size_t>(s) * nc * P : nullptr;
  const int sgn = down ? 1 : -1;
  const int T0 = tree_len(p0), T1 = tree_len(p1);
  const int nth = blockDim.x;
  const FastDiv by_p1(p1);
  // plane q's input, tap weight rows and sum trees into the L2 (rows of
  // a multiple of 16 bytes only: the bulk prefetch takes no other)
  const size_t tr0 = static_cast<size_t>(T0) * p1, tr1 = static_cast<size_t>(T1) * p0;
  const bool can_prefetch = (static_cast<size_t>(P) * sizeof(T)) % 16 == 0 &&
                            (tr0 * sizeof(T)) % 16 == 0 && (tr1 * sizeof(T)) % 16 == 0;
  const auto prefetch_plane = [&](int q) {
    if (!can_prefetch || threadIdx.x != 0) return;
    const size_t row = static_cast<size_t>(P) * sizeof(T);
    prefetch_l2(in + static_cast<size_t>(q) * P, row);
    for (int t = 0; t < n_cross + n_inpl; ++t)
      prefetch_l2(W + (static_cast<size_t>(q) * ns + __ldg(&taps[4 * t])) * P, row);
    if (tr0) {
      prefetch_l2(t0f + q * tr0, tr0 * sizeof(T));
      prefetch_l2(t0b + q * tr0, tr0 * sizeof(T));
    }
    if (tr1) {
      prefetch_l2(t1f + q * tr1, tr1 * sizeof(T));
      prefetch_l2(t1b + q * tr1, tr1 * sizeof(T));
    }
  };
  prefetch_plane(down ? nA - 1 : 0);
  for (int j = 0; j < nA; ++j) {
    const int p = down ? nA - 1 - j : j;
    const T* Wp = W + static_cast<size_t>(p) * ns * P;
    if (j + 1 < nA) prefetch_plane(down ? p - 1 : p + 1);
    // 1. the input plane and the cross taps, kG nodes a thread at once
    for (int i0 = threadIdx.x; i0 < P; i0 += kG * nth) {
      T v[kG];
      int a[kG], b[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int idx = i0 + g * nth;
        const int q = by_p1.div(idx);
        a[g] = idx < P ? q : -p0 - 2;  // a node past the plane takes no tap
        b[g] = idx - q * p1;
        v[g] = idx < P ? in[static_cast<size_t>(p) * P + idx] : T(0);
      }
      for (int t = 0; t < n_cross; ++t) {
        const int m = __ldg(&taps[4 * t + 1]);
        const int da = __ldg(&taps[4 * t + 2]), db = __ldg(&taps[4 * t + 3]);
        const T* prev;
        if (j >= m) {
          prev = out + static_cast<size_t>(p + m * sgn) * P;
        } else {
          const int c = m - 1 - j;
          if (c >= nc) continue;  // +inf plane
          prev = car + static_cast<size_t>(c) * P;
        }
        const T* Ws = Wp + static_cast<size_t>(__ldg(&taps[4 * t])) * P;
        T src[kG], w[kG];
        bool ok[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int na = a[g] + da, nb = b[g] + db;
          ok[g] = na >= 0 && na < p0 && nb >= 0 && nb < p1;  // else +inf weight
          if (ok[g]) {
            src[g] = prev[na * p1 + nb];
            w[g] = Ws[i0 + g * nth];
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (ok[g]) v[g] = min_of(v[g], add_rn(src[g], w[g]));
      }
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (i0 + g * nth < P) cur[i0 + g * nth] = v[g];
    }
    __syncthreads();
    // 2. the in-plane taps, one Jacobi update of the plane each: from A
    // into B, then B is the plane (ping-pong between two shared planes;
    // with one, B is the device-memory plane, copied back a tap)
    T* A = cur;
    T* B = X;
    for (int t = n_cross; t < n_cross + n_inpl; ++t) {
      const int sft = __ldg(&taps[4 * t]);
      const int da = __ldg(&taps[4 * t + 2]), db = __ldg(&taps[4 * t + 3]);
      const T* Ws = Wp + static_cast<size_t>(sft) * P;
      for (int i0 = threadIdx.x; i0 < P; i0 += kG * nth) {
        T w[kG];
        int nbr[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int idx = i0 + g * nth;
          const int a = by_p1.div(idx), b = idx - a * p1;
          const int na = a + da, nb = b + db;
          nbr[g] = idx < P && na >= 0 && na < p0 && nb >= 0 && nb < p1 ? na * p1 + nb : -1;
          if (nbr[g] >= 0) w[g] = Ws[idx];
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int idx = i0 + g * nth;
          if (idx < P) {
            T v = A[idx];
            if (nbr[g] >= 0) v = min_of(v, add_rn(A[nbr[g]], w[g]));
            B[idx] = v;
          }
        }
      }
      __syncthreads();
      if (planes >= 2) {
        T* tmp = A;
        A = B;
        B = tmp;
      } else {
        for (int idx = threadIdx.x; idx < P; idx += nth) cur[idx] = X[idx];
        __syncthreads();
      }
    }
    if (A != cur) {  // an odd number of ping-pong taps
      for (int idx = threadIdx.x; idx < P; idx += nth) cur[idx] = A[idx];
      __syncthreads();
    }
    // 3. the scans along plane axis 0, then along plane axis 1
    scan_axis(cur, X, Y, t0f + static_cast<size_t>(p) * tr0, t0b + static_cast<size_t>(p) * tr0,
              0, p0, p1);
    scan_axis(cur, X, Y, t1f + static_cast<size_t>(p) * tr1, t1b + static_cast<size_t>(p) * tr1,
              1, p0, p1);
    // 4. the output plane, which later planes read as their prev
    for (int idx = threadIdx.x; idx < P; idx += nth)
      out[static_cast<size_t>(p) * P + idx] = cur[idx];
    __syncthreads();
  }
}

template <typename T>
int launch(const void* din, void* dout, const void* W, const void* t0f, const void* t0b,
           const void* t1f, const void* t1b, const void* carry, void* xbuf, int S, int nA,
           int p0, int p1, int ns, int nc, int n_cross, int n_inpl, int down, int planes,
           int smem, const void* taps, cudaStream_t st) {
  const size_t plane = static_cast<size_t>(p0) * p1 * sizeof(T);
  if (planes < 1 || planes > 3 || static_cast<size_t>(smem) != planes * plane ||
      (planes == 1 && !xbuf))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  plane3d_kernel<T><<<S, kThreads, smem, st>>>(
      static_cast<const T*>(din), static_cast<T*>(dout), static_cast<const T*>(W),
      static_cast<const T*>(t0f), static_cast<const T*>(t0b), static_cast<const T*>(t1f),
      static_cast<const T*>(t1b), static_cast<const T*>(carry), static_cast<T*>(xbuf),
      static_cast<const int*>(taps), nA, p0, p1, ns, nc, n_cross, n_inpl, down, planes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one directional pass on `stream`; returns the CUDA error as an
// int (0 when the launch was accepted).  din and dout (S, nA, p0, p1), W
// (nA, ns, p0, p1), the trees of ops/plane3d.scan_sum_trees, carry (S,
// nc, p0, p1) or null when nc is 0, xbuf (S, p0*p1) when `planes` is 1
// (else null): float32, or float64 when is_double; taps (n_cross +
// n_inpl, 4) int32 rows (shift, m, da, db); all contiguous device memory.
// smem is the block's dynamic shared memory, `planes` planes (1-3).  One
// block of 1,024 threads a source.
extern "C" int plane3d_launch(const void* din, void* dout, const void* W, const void* t0f,
                              const void* t0b, const void* t1f, const void* t1b,
                              const void* carry, void* xbuf, int S, int nA, int p0, int p1,
                              int ns, int nc, int n_cross, int n_inpl, int down, int planes,
                              int smem, int is_double, const void* taps, void* stream) {
  if (S < 1 || nA < 1 || p0 < 1 || p1 < 1 || ns < 1 || nc < 0 || (nc > 0 && !carry) ||
      n_cross < 0 || n_inpl < 0 || smem < 1 || static_cast<size_t>(smem) > minplus::kBlockSmem ||
      static_cast<long long>(p0) * p1 > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(din, dout, W, t0f, t0b, t1f, t1b, carry, xbuf, S, nA, p0,
                                    p1, ns, nc, n_cross, n_inpl, down, planes, smem, taps, st)
                   : launch<float>(din, dout, W, t0f, t0b, t1f, t1b, carry, xbuf, S, nA, p0,
                                   p1, ns, nc, n_cross, n_inpl, down, planes, smem, taps, st);
}
