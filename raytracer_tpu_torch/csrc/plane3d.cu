// One directional plane pass of the 3-D sweep engine.
//
// A kernel of the port's own choice: the JAX package runs this pass as
// XLA, a lax.scan over the planes (raytracer_tpu/solvers/solve3d.py
// _plane_sweep3d), with no Pallas kernel.  Python wrapper, launch planner,
// tables and plain PyTorch twin: raytracer_tpu_torch/ops/plane3d.py
// (plane_sweep3d, plane3d_plan, scan_sum_trees, plane_sweep3d_reference;
// plane3d_scan_reference replays the scans' levels).
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
// Every update only lowers a value, so a scan's result is at most x, and
// min(x, forward, backward) is min(forward, backward).
//
// What bounds it on an H100.  At 128x128x64 and star 1 a pass reads the
// field once and writes it once (8.4 MB), reads 17 of the 26 weight
// planes a node (71 MB) and the four scan-cost stacks (16.8 MB): ~0.03
// ms at 3.35 TB/s; its ~51 M adds and minima are ~1 us at 67 TFLOP/s
// f32.  But the planes depend on each other (plane p's cross taps read
// plane p -/+ 1), the in-plane taps are one Jacobi step after another,
// and each scan level waits on the last.  The first design ran a source
// on one block of 1,024 threads (one SM), the line scans level by level
// with a block barrier a level (~80 block barriers a plane), and every
// thread worked through 16 nodes a step: latency on one SM.
//
// The design.  A cluster of `cs` blocks (thread-block clusters, 8 for the
// production planes, up to 16 with the non-portable size; 1 for small
// planes: ops/plane3d.plane3d_plan) runs a source; block `rank` owns the
// rows [rank R, rank R + R) of every plane (R = ceil(p0 / cs)) in its
// shared memory, in three band buffers, and the columns [rank Cw, rank Cw
// + Cw) for the axis-0 scans (Cw = ceil(p1 / cs)).
//   1. the cross taps of its rows (and its edge rows into the
//      neighbours' halos), reading the previous planes back from the
//      output (the L2 holds them);
//   2. the in-plane taps, in band buffers with hh halo rows each side
//      (twice the taps' reach across rows): a block writes its edge rows
//      into its neighbours' halo rows through distributed shared memory
//      (the cluster's map_shared_rank) as it computes them, so every read
//      is local; two taps a cluster barrier (the first of a pair also
//      computes the halo rows the second reads: the same floats), the
//      barrier split into its arrive and its wait with the next tap's
//      weight loads between them;
//   3. the axis-0 scans: the block gathers its columns from every band
//      through distributed shared memory into its two free buffers
//      (forward and backward copies); a warp owns whole columns and runs
//      the levels of both with __syncwarp only; the block writes
//      min(forward, backward) back into the owning bands; a cluster
//      barrier;
//   4. the axis-1 scans: a warp owns whole rows of its band, the same
//      warp-level levels, and writes its output rows; a cluster barrier
//      (the next plane's cross taps read them).
// So a plane costs 3 + ceil(n_inpl / 2) cluster barriers and a block
// barrier a pair of taps and two around the axis-0 levels, and no barrier
// inside a scan.  The plane's
// sum trees for its columns and rows come into shared memory by cp.async
// when the plane starts (waited before the first barrier); the next
// plane's input and weight rows of its band go to the L2 by bulk
// prefetches (cp.async.bulk.prefetch.L2); each thread starts the loads of
// kG nodes before it takes their minima; plane coordinates come from a
// multiply-high division.

//
// The global route (plane3d_global_launch) takes a plane that no cluster
// of up to 16 blocks holds in shared memory (ops/plane3d.plane3d_plan
// picks it from the shapes).  The plane lives in global memory, two
// buffers of (S, p0, p1), and the steps that the cluster design separates
// by cluster barriers become separate launches, enqueued by the host
// function a plane at a time: the input plane with its cross taps (a
// thread a node), each in-plane tap (a Jacobi update, a thread a node),
// the axis-0 line scans and the axis-1 line scans (a warp a line, the
// same levels as scan_line, the line's forward copy in place and its
// backward copy in the other buffer, the output min(forward, backward)).
// Correctness first: 3 + n_inpl launches a plane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace cg = cooperative_groups;

namespace {

using minplus::add_rn;
using minplus::min_of;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kG = 4;  // nodes a thread loads at once

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
__host__ __device__ __forceinline__ int tree_len(int n) {
  int t = 0;
  for (int m = n; m >= 2; m >>= 1) t += m;
  return t;
}

// values of one block's shared memory (ops/plane3d.py plane3d_smem_bytes):
// three band buffers of max((R + 2 hh) p1, Cw (p0 + 1)) values (its rows
// with hh halo rows each side, or its columns at a line stride of p0 +
// 1), the axis-0 trees of its columns (2 x Cw x T0) and the axis-1 trees
// of its rows (2 x R x T1)
__host__ __device__ __forceinline__ long long smem_values(int p0, int p1, int cs, int hh) {
  const long long R = (p0 + cs - 1) / cs, Cw = (p1 + cs - 1) / cs;
  const long long rows = (R + 2 * hh) * p1, cols = Cw * (p0 + 1);
  const long long band = rows > cols ? rows : cols;
  return 3 * band + 2LL * tree_len(p0) * Cw + 2LL * R * tree_len(p1);
}

// The forward scan of the line F[0 .. n) and the backward scan of G (the
// same line, reversed by index arithmetic), in place, by the 32 lanes of
// one warp, level by level with __syncwarp; the sums of level value k at
// sf[k] and sb[k]
template <typename T>
__device__ void scan_line(T* F, T* G, int n, const T* sf, const T* sb, int lane) {
  int L = 0, off = 0;
  for (int m = n; m >= 2; m >>= 1) ++L;
  for (int l = 0; l < L; ++l) {  // up
    const int len = n >> l, h = 1 << l;
    for (int i = lane; i < len >> 1; i += 32) {
      const int p = ((2 * i + 2) << l) - 1;
      const int k = off + 2 * i + 1;
      F[p] = min_of(add_rn(F[p - h], sf[k]), F[p]);
      G[n - 1 - p] = min_of(add_rn(G[n - 1 - p + h], sb[k]), G[n - 1 - p]);
    }
    off += len;
    __syncwarp();
  }
  for (int l = L - 1; l >= 0; --l) {  // down
    const int len = n >> l, h = 1 << l;
    off -= len;
    for (int i = lane + 1; i <= (len - 1) >> 1; i += 32) {
      const int q = ((2 * i + 1) << l) - 1;
      const int k = off + 2 * i;
      F[q] = min_of(add_rn(F[q - h], sf[k]), F[q]);
      G[n - 1 - q] = min_of(add_rn(G[n - 1 - q + h], sb[k]), G[n - 1 - q]);
    }
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  cp_async_ca<sizeof(T)>(dst, src);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
plane3d_kernel(const T* __restrict__ din, T* __restrict__ dout, const T* __restrict__ W,
               const T* __restrict__ t0f, const T* __restrict__ t0b,
               const T* __restrict__ t1f, const T* __restrict__ t1b,
               const T* __restrict__ carry, const int* __restrict__ taps, int nA, int p0,
               int p1, int ns, int nc, int n_cross, int n_inpl, int down, int hh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int s = blockIdx.x / cs;
  const int P = p0 * p1;
  const int R = (p0 + cs - 1) / cs, Cw = (p1 + cs - 1) / cs;
  const int r0 = rank * R, c0 = rank * Cw;
  const int nrows = max(0, min(p0, r0 + R) - r0), ncols = max(0, min(p1, c0 + Cw) - c0);
  const int Pb = nrows * p1;
  const int T0 = tree_len(p0), T1 = tree_len(p1);
  const int ls0 = p0 + 1;  // line stride of the column copies
  const int band = max((R + 2 * hh) * p1, Cw * ls0);
  T* bufs[3];
  bufs[0] = reinterpret_cast<T*>(smem_raw);
  bufs[1] = bufs[0] + band;
  bufs[2] = bufs[1] + band;
  T* tr0f = bufs[2] + band;  // (Cw, T0): column c0 + c at c * T0 + k
  T* tr0b = tr0f + static_cast<size_t>(Cw) * T0;
  T* tr1f = tr0b + static_cast<size_t>(Cw) * T0;  // (R, T1): row r0 + r at r * T1 + k
  T* tr1b = tr1f + static_cast<size_t>(R) * T1;
  const T* in = din + static_cast<size_t>(s) * nA * P;
  T* out = dout + static_cast<size_t>(s) * nA * P;
  const T* car = carry ? carry + static_cast<size_t>(s) * nc * P : nullptr;
  const int sgn = down ? 1 : -1;
  const int nth = blockDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = nth >> 5;
  const FastDiv by_p1(p1), by_cols(max(ncols, 1));
  const auto csync = [&]() {
    if (cs == 1)
      __syncthreads();
    else
      cl.sync();
  };
  // a cluster barrier with `f` run between its arrive and its wait (loads
  // that stay in flight over the wait)
  const auto csync_over = [&](auto f) {
    if (cs == 1) {
      f();
      __syncthreads();
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      f();
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  };
  // A band buffer holds rows [r0 - hh, r0 + R + hh): its own and hh halo
  // rows each side, copies of the neighbours' edge rows (none on a
  // cluster of one).  Row a of the
  // buffer `buf` (this block's offset of it) in whichever block of the
  // cluster owns that row:
  const auto row_of = [&](T* buf, int a) -> T* {
    const int q = a / R;
    T* base = q == rank ? buf : cl.map_shared_rank(buf, q);
    return base + static_cast<size_t>(a - q * R + hh) * p1;
  };
  // value x of own row r0 + q, column b, into `buf`, and into the halo
  // rows of the neighbour blocks whose halo it is (R >= hh: only the two
  // next to this one)
  const auto store = [&](T* buf, int q, int b, T x) {
    buf[(q + hh) * p1 + b] = x;
    if (q < hh && rank > 0) cl.map_shared_rank(buf, rank - 1)[(q + R + hh) * p1 + b] = x;
    if (q >= nrows - hh && r0 + R < p0)
      cl.map_shared_rank(buf, rank + 1)[(q - R + hh) * p1 + b] = x;
  };
  // plane q's input and tap weight rows of this band into the L2 (rows
  // of a multiple of 16 bytes only: the bulk prefetch takes no other)
  const bool can_prefetch = (static_cast<size_t>(p1) * sizeof(T)) % 16 == 0 && Pb > 0;
  const auto prefetch_plane = [&](int q) {
    if (!can_prefetch || threadIdx.x != 0) return;
    const size_t bytes = static_cast<size_t>(Pb) * sizeof(T);
    const size_t at = static_cast<size_t>(r0) * p1;
    prefetch_l2(in + static_cast<size_t>(q) * P + at, bytes);
    for (int t = 0; t < n_cross + n_inpl; ++t)
      prefetch_l2(W + (static_cast<size_t>(q) * ns + __ldg(&taps[4 * t])) * P + at, bytes);
  };

  cl.sync();  // every block of the cluster runs before any reads another's memory
  prefetch_plane(down ? nA - 1 : 0);
  for (int j = 0; j < nA; ++j) {
    const int p = down ? nA - 1 - j : j;
    const T* Wp = W + static_cast<size_t>(p) * ns * P;
    // 0. this plane's sum trees of the band's columns and rows
    {
      const size_t b0 = static_cast<size_t>(p) * T0 * p1 + c0;
      for (int e = threadIdx.x; e < T0 * ncols; e += nth) {
        const int k = e / ncols, c = e - k * ncols;
        copy_async(tr0f + c * T0 + k, t0f + b0 + static_cast<size_t>(k) * p1 + c);
        copy_async(tr0b + c * T0 + k, t0b + b0 + static_cast<size_t>(k) * p1 + c);
      }
      const size_t b1 = (static_cast<size_t>(p) * p0 + r0) * T1;
      for (int e = threadIdx.x; e < nrows * T1; e += nth) {
        copy_async(tr1f + e, t1f + b1 + e);
        copy_async(tr1b + e, t1b + b1 + e);
      }
      cp_async_commit();
    }
    if (j + 1 < nA) prefetch_plane(down ? p - 1 : p + 1);
    // 1. the input plane and the cross taps of the band, kG nodes a
    // thread at once, into bufs[0]
    T* cur = bufs[0];
    for (int i0 = threadIdx.x; i0 < Pb; i0 += kG * nth) {
      T v[kG];
      int a[kG], b[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int li = i0 + g * nth;
        const int q = by_p1.div(li);
        a[g] = li < Pb ? r0 + q : -p0 - 2;  // a node past the band takes no tap
        b[g] = li - q * p1;
        v[g] = li < Pb ? in[static_cast<size_t>(p) * P + r0 * p1 + li] : T(0);
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
        const T* Ws = Wp + static_cast<size_t>(__ldg(&taps[4 * t])) * P + r0 * p1;
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
        if (i0 + g * nth < Pb) store(cur, a[g] - r0, b[g], v[g]);
    }
    cp_async_wait_all();
    // 2. the in-plane taps, one Jacobi update of the plane each, two at a
    // time between cluster barriers: the first of a pair also computes
    // the hr = hh / 2 halo rows each side (the neighbours' edge rows: the
    // same floats), so the second needs nothing from another block; its
    // edge rows go hh deep into the neighbours' halos.  A lone last tap
    // (an odd count) goes from A into M with its edge rows pushed.
    const int te = n_cross + n_inpl, hr = hh / 2;
    const int qlo = max(-hr, -r0), qhi = min(nrows + hr, p0 - r0);
    const int Pe = nrows > 0 ? (qhi - qlo) * p1 : 0;  // a pair's first tap's nodes
    // the weights of tap t for this thread's first kG nodes of rows
    // [q0, ...) (Pn nodes), loaded while a barrier completes
    T wn[kG], wn2[kG];
    const auto load_w = [&](T (&w)[kG], int t, int q0, int Pn) {
      if (t >= te) return;
      const T* Ws = Wp + static_cast<size_t>(__ldg(&taps[4 * t])) * P + (r0 + q0) * p1;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int li = threadIdx.x + g * nth;
        if (li < Pn) w[g] = Ws[li];
      }
    };
    const auto load_first = [&](int t) {  // tap t heads a pair, or is alone
      if (t + 1 < te)
        load_w(wn, t, qlo, Pe);
      else
        load_w(wn, t, 0, Pb);
    };
    // one tap from X into Y over rows [q0, ...) (Pn nodes); with `push`
    // the own rows go through store (edge rows into the neighbours'
    // halos), else into Y's rows only
    const auto tap = [&](const T* X, T* Y, int t, int q0, int Pn, const T (&w0)[kG],
                         bool push) {
      const int sft = __ldg(&taps[4 * t]);
      const int da = __ldg(&taps[4 * t + 2]), db = __ldg(&taps[4 * t + 3]);
      const T* Ws = Wp + static_cast<size_t>(sft) * P + (r0 + q0) * p1;
      for (int i0 = threadIdx.x; i0 < Pn; i0 += kG * nth) {
        T w[kG], src[kG];
        int nbr[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int li = i0 + g * nth;
          const int q = q0 + by_p1.div(li);
          const int na = r0 + q + da, nb = li - (q - q0) * p1 + db;
          nbr[g] = li < Pn && na >= 0 && na < p0 && nb >= 0 && nb < p1;
          if (nbr[g]) {
            w[g] = i0 == threadIdx.x ? w0[g] : Ws[li];
            src[g] = X[(na - r0 + hh) * p1 + nb];  // own or halo row
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int li = i0 + g * nth;
          if (li < Pn) {
            const int q = q0 + by_p1.div(li), b = li - (q - q0) * p1;
            T v = X[(q + hh) * p1 + b];
            if (nbr[g]) v = min_of(v, add_rn(src[g], w[g]));
            if (push)
              store(Y, q, b, v);
            else
              Y[(q + hh) * p1 + b] = v;
          }
        }
      }
    };
    csync_over([&] { load_first(n_cross); });
    T* A = bufs[0];  // the plane
    T* M = bufs[1];
    T* D = bufs[2];
    for (int t = n_cross; t < te; t += 2) {
      if (t + 1 < te) {
        load_w(wn2, t + 1, 0, Pb);
        tap(A, M, t, qlo, Pe, wn, false);
        __syncthreads();
        tap(M, D, t + 1, 0, Pb, wn2, true);
        csync_over([&] { load_first(t + 2); });
        T* tmp = A;
        A = D;
        D = tmp;
      } else {
        tap(A, M, t, 0, Pb, wn, true);
        csync_over([] {});
        T* tmp = A;
        A = M;
        M = tmp;
      }
    }
    // the two buffers A is not: the scans' forward and backward copies
    T* F = M;
    T* G = D;
    // 3. the axis-0 scans: the block's columns gathered from every band
    // (neighbouring threads on neighbouring columns of a row), a warp a
    // column for the levels, then written back
    for (int e = threadIdx.x; e < p0 * ncols; e += nth) {
      const int a = by_cols.div(e), c = e - a * ncols;
      const T x = row_of(A, a)[c0 + c];
      F[c * ls0 + a] = x;
      G[c * ls0 + a] = x;
    }
    __syncthreads();
    for (int c = warp; c < ncols; c += nwarps)
      scan_line(F + c * ls0, G + c * ls0, p0, tr0f + static_cast<size_t>(c) * T0,
                tr0b + static_cast<size_t>(c) * T0, lane);
    __syncthreads();
    for (int e = threadIdx.x; e < p0 * ncols; e += nth) {
      const int a = by_cols.div(e), c = e - a * ncols;
      row_of(A, a)[c0 + c] = min_of(F[c * ls0 + a], G[c * ls0 + a]);
    }
    csync();
    // 4. the axis-1 scans: a warp a row of the band; the output rows
    for (int r = warp; r < nrows; r += nwarps) {
      const T* Al = A + static_cast<size_t>(r + hh) * p1;
      T* Fl = F + static_cast<size_t>(r) * p1;
      T* Gl = G + static_cast<size_t>(r) * p1;
      for (int b = lane; b < p1; b += 32) {
        const T x = Al[b];
        Fl[b] = x;
        Gl[b] = x;
      }
      __syncwarp();
      scan_line(Fl, Gl, p1, tr1f + static_cast<size_t>(r) * T1,
                tr1b + static_cast<size_t>(r) * T1, lane);
      T* o = out + static_cast<size_t>(p) * P + static_cast<size_t>(r0 + r) * p1;
      for (int b = lane; b < p1; b += 32) o[b] = min_of(Fl[b], Gl[b]);
    }
    // the output rows reach the cluster's next cross taps, and the
    // buffers and trees are free again
    csync();
  }
  cl.sync();  // no block leaves while another may still read its memory
}

// ---- the global route ----

constexpr int kGlobalThreads = 256;

// node (s, li) of plane p, li = a p1 + b: its input and the cross taps
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
    g_cross_kernel(const T* __restrict__ din, const T* dout, const T* __restrict__ W,
                   const T* __restrict__ carry, const int* __restrict__ taps, T* A, int nA,
                   int p0, int p1, int ns, int nc, int n_cross, int down, int p, int j) {
  const int P = p0 * p1;
  const int li = blockIdx.x * blockDim.x + threadIdx.x;
  if (li >= P) return;
  const int s = blockIdx.y;
  const int a = li / p1, b = li - (li / p1) * p1;
  const int sgn = down ? 1 : -1;
  const T* Wp = W + static_cast<size_t>(p) * ns * P;
  T v = din[(static_cast<size_t>(s) * nA + p) * P + li];
  for (int t = 0; t < n_cross; ++t) {
    const int m = __ldg(&taps[4 * t + 1]);
    const int na = a + __ldg(&taps[4 * t + 2]), nb = b + __ldg(&taps[4 * t + 3]);
    if (na < 0 || na >= p0 || nb < 0 || nb >= p1) continue;  // a +inf weight
    const T* prev;
    if (j >= m) {
      prev = dout + (static_cast<size_t>(s) * nA + p + m * sgn) * P;
    } else {
      const int c = m - 1 - j;
      if (c >= nc) continue;  // +inf plane
      prev = carry + (static_cast<size_t>(s) * nc + c) * P;
    }
    const T w = Wp[static_cast<size_t>(__ldg(&taps[4 * t])) * P + li];
    v = min_of(v, add_rn(prev[na * p1 + nb], w));
  }
  A[static_cast<size_t>(s) * P + li] = v;
}

// one in-plane tap t, X into Y
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
    g_inpl_kernel(const T* X, T* Y, const T* __restrict__ W, const int* __restrict__ taps,
                  int p0, int p1, int ns, int p, int t) {
  const int P = p0 * p1;
  const int li = blockIdx.x * blockDim.x + threadIdx.x;
  if (li >= P) return;
  const size_t o = static_cast<size_t>(blockIdx.y) * P;
  const int a = li / p1, b = li - (li / p1) * p1;
  const int na = a + __ldg(&taps[4 * t + 2]), nb = b + __ldg(&taps[4 * t + 3]);
  T v = X[o + li];
  if (na >= 0 && na < p0 && nb >= 0 && nb < p1) {
    const T w = W[(static_cast<size_t>(p) * ns + __ldg(&taps[4 * t])) * P + li];
    v = min_of(v, add_rn(X[o + na * p1 + nb], w));
  }
  Y[o + li] = v;
}

// a warp a line of n values at stride ls (line q of field s at X + s P +
// q qs): F = the line in place, G its copy in G's same place; the levels
// of scan_line with the sums at sf[k ts], sb[k ts]; then dst = min(F, G)
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
    g_scan_kernel(T* X, T* G, T* dst, size_t dst_s, const T* __restrict__ tf,
                  const T* __restrict__ tb, int P, int lines, int n, int ls, int qs, int tq,
                  int ts, int S) {
  const int lane = threadIdx.x & 31;
  const long long wq = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (wq >= static_cast<long long>(S) * lines) return;  // the whole warp
  const int s = static_cast<int>(wq / lines), q = static_cast<int>(wq % lines);
  T* F = X + static_cast<size_t>(s) * P + static_cast<size_t>(q) * qs;
  T* Gl = G + static_cast<size_t>(s) * P + static_cast<size_t>(q) * qs;
  const T* sf = tf + static_cast<size_t>(q) * tq;
  const T* sb = tb + static_cast<size_t>(q) * tq;
  for (int i = lane; i < n; i += 32) Gl[static_cast<size_t>(i) * ls] = F[static_cast<size_t>(i) * ls];
  __syncwarp();
  int L = 0, off = 0;
  for (int m = n; m >= 2; m >>= 1) ++L;
  const auto at = [&](T* Z, int i) -> T& { return Z[static_cast<size_t>(i) * ls]; };
  for (int l = 0; l < L; ++l) {  // up
    const int len = n >> l, h = 1 << l;
    for (int i = lane; i < len >> 1; i += 32) {
      const int pp = ((2 * i + 2) << l) - 1;
      const size_t k = static_cast<size_t>(off + 2 * i + 1) * ts;
      at(F, pp) = min_of(add_rn(at(F, pp - h), sf[k]), at(F, pp));
      at(Gl, n - 1 - pp) = min_of(add_rn(at(Gl, n - 1 - pp + h), sb[k]), at(Gl, n - 1 - pp));
    }
    off += len;
    __syncwarp();
  }
  for (int l = L - 1; l >= 0; --l) {  // down
    const int len = n >> l, h = 1 << l;
    off -= len;
    for (int i = lane + 1; i <= (len - 1) >> 1; i += 32) {
      const int qq = ((2 * i + 1) << l) - 1;
      const size_t k = static_cast<size_t>(off + 2 * i) * ts;
      at(F, qq) = min_of(add_rn(at(F, qq - h), sf[k]), at(F, qq));
      at(Gl, n - 1 - qq) = min_of(add_rn(at(Gl, n - 1 - qq + h), sb[k]), at(Gl, n - 1 - qq));
    }
    __syncwarp();
  }
  T* D = dst + static_cast<size_t>(s) * dst_s + static_cast<size_t>(q) * qs;
  for (int i = lane; i < n; i += 32)
    D[static_cast<size_t>(i) * ls] = min_of(F[static_cast<size_t>(i) * ls], Gl[static_cast<size_t>(i) * ls]);
}

template <typename T>
int launch_global(const void* din_, void* dout_, const void* W_, const void* t0f_,
                  const void* t0b_, const void* t1f_, const void* t1b_, const void* carry_,
                  void* scratch_, int S, int nA, int p0, int p1, int ns, int nc, int n_cross,
                  int n_inpl, int down, const void* taps_, cudaStream_t st) {
  const T* din = static_cast<const T*>(din_);
  T* dout = static_cast<T*>(dout_);
  const T* W = static_cast<const T*>(W_);
  const T *t0f = static_cast<const T*>(t0f_), *t0b = static_cast<const T*>(t0b_);
  const T *t1f = static_cast<const T*>(t1f_), *t1b = static_cast<const T*>(t1b_);
  const T* carry = static_cast<const T*>(carry_);
  const int* taps = static_cast<const int*>(taps_);
  const int P = p0 * p1;
  T* bufs[2] = {static_cast<T*>(scratch_), static_cast<T*>(scratch_) + static_cast<size_t>(S) * P};
  const dim3 nodes((P + kGlobalThreads - 1) / kGlobalThreads, S);
  const int T0 = tree_len(p0), T1 = tree_len(p1);
  const auto warps = [&](int lines) {
    return static_cast<unsigned>((static_cast<long long>(S) * lines * 32 + kGlobalThreads - 1) /
                                 kGlobalThreads);
  };
  for (int j = 0; j < nA; ++j) {
    const int p = down ? nA - 1 - j : j;
    g_cross_kernel<T><<<nodes, kGlobalThreads, 0, st>>>(din, dout, W, carry, taps, bufs[0], nA, p0,
                                                        p1, ns, nc, n_cross, down, p, j);
    int x = 0;
    for (int t = n_cross; t < n_cross + n_inpl; ++t, x ^= 1)
      g_inpl_kernel<T><<<nodes, kGlobalThreads, 0, st>>>(bufs[x], bufs[x ^ 1], W, taps, p0, p1, ns,
                                                         p, t);
    // axis 0: a line a column b (stride p1), the trees at (p, k, b)
    g_scan_kernel<T><<<warps(p1), kGlobalThreads, 0, st>>>(
        bufs[x], bufs[x ^ 1], bufs[x], static_cast<size_t>(P), t0f + static_cast<size_t>(p) * T0 * p1,
        t0b + static_cast<size_t>(p) * T0 * p1, P, p1, p0, p1, 1, 1, p1, S);
    // axis 1: a line a row a (stride 1), the trees at (p, a, k); into the output plane
    g_scan_kernel<T><<<warps(p0), kGlobalThreads, 0, st>>>(
        bufs[x], bufs[x ^ 1], dout + static_cast<size_t>(p) * P, static_cast<size_t>(nA) * P,
        t1f + static_cast<size_t>(p) * p0 * T1, t1b + static_cast<size_t>(p) * p0 * T1, P, p0, p1, 1,
        p1, T1, 1, S);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int launch(const void* din, void* dout, const void* W, const void* t0f, const void* t0b,
           const void* t1f, const void* t1b, const void* carry, int S, int nA, int p0, int p1,
           int ns, int nc, int n_cross, int n_inpl, int down, int hh, int cs, int threads,
           int smem,
           const void* taps, cudaStream_t st) {
  if (cs < 1 || cs > kMaxCluster || cs > p0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 ||
      hh < 0 || hh % 2 || (cs > 1 && (p0 + cs - 1) / cs < hh) || (cs == 1 && hh) ||
      static_cast<long long>(smem) != smem_values(p0, p1, cs, hh) * static_cast<long long>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  static bool non_portable = false;
  if (cs > 8 && !non_portable) {
    const cudaError_t e =
        cudaFuncSetAttribute(plane3d_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, plane3d_kernel<T>, static_cast<const T*>(din), static_cast<T*>(dout),
      static_cast<const T*>(W), static_cast<const T*>(t0f), static_cast<const T*>(t0b),
      static_cast<const T*>(t1f), static_cast<const T*>(t1b), static_cast<const T*>(carry),
      static_cast<const int*>(taps), nA, p0, p1, ns, nc, n_cross, n_inpl, down, hh);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one directional pass on `stream`; returns the CUDA error as an
// int (0 when the launch was accepted; a refused cluster launch returns
// its error, never another route).  din and dout (S, nA, p0, p1), W (nA,
// ns, p0, p1), the trees of ops/plane3d.scan_sum_trees, carry (S, nc, p0,
// p1) or null when nc is 0: float32, or float64 when is_double; taps
// (n_cross + n_inpl, 4) int32 rows (shift, m, da, db), |da| <= hh / 2 for
// the in-plane taps on a cluster; all contiguous device memory.  S
// clusters of `cs` blocks (1-16, at most p0; ceil(p0 / cs) >= hh when cs >
// 1, hh = 0 when cs is 1) of `threads`
// threads, each block with `smem` bytes of dynamic shared memory
// (ops/plane3d.plane3d_plan).
extern "C" int plane3d_launch(const void* din, void* dout, const void* W, const void* t0f,
                              const void* t0b, const void* t1f, const void* t1b,
                              const void* carry, int S, int nA, int p0, int p1, int ns, int nc,
                              int n_cross, int n_inpl, int down, int hh, int cs, int threads,
                              int smem, int is_double, const void* taps, void* stream) {
  if (S < 1 || nA < 1 || p0 < 1 || p1 < 1 || ns < 1 || nc < 0 || (nc > 0 && !carry) ||
      n_cross < 0 || n_inpl < 0 || smem < 1 || static_cast<size_t>(smem) > minplus::kBlockSmem ||
      static_cast<long long>(p0) * p1 > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(din, dout, W, t0f, t0b, t1f, t1b, carry, S, nA, p0, p1, ns,
                                    nc, n_cross, n_inpl, down, hh, cs, threads, smem, taps, st)
                   : launch<float>(din, dout, W, t0f, t0b, t1f, t1b, carry, S, nA, p0, p1, ns,
                                   nc, n_cross, n_inpl, down, hh, cs, threads, smem, taps, st);
}

// Launches one directional pass on the global route on `stream` (3 +
// n_inpl launches a plane); returns the CUDA error as an int.  The
// arguments as for plane3d_launch, with scratch (2, S, p0, p1) of the
// field's type and no cluster, threads or shared memory.
extern "C" int plane3d_global_launch(const void* din, void* dout, const void* W,
                                     const void* t0f, const void* t0b, const void* t1f,
                                     const void* t1b, const void* carry, void* scratch, int S,
                                     int nA, int p0, int p1, int ns, int nc, int n_cross,
                                     int n_inpl, int down, int is_double, const void* taps,
                                     void* stream) {
  if (S < 1 || S > 65535 || nA < 1 || p0 < 1 || p1 < 1 || ns < 1 || nc < 0 ||
      (nc > 0 && !carry) || n_cross < 0 || n_inpl < 0 || !scratch || !taps ||
      static_cast<long long>(p0) * p1 > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_global<double>(din, dout, W, t0f, t0b, t1f, t1b, carry, scratch, S, nA,
                                           p0, p1, ns, nc, n_cross, n_inpl, down, taps, st)
                   : launch_global<float>(din, dout, W, t0f, t0b, t1f, t1b, carry, scratch, S, nA,
                                          p0, p1, ns, nc, n_cross, n_inpl, down, taps, st);
}
