// The banded solver's two steps on an RCM-ordered graph: Jacobi
// iterations (banded_sweep, many a launch) and one Gauss-Seidel
// direction (banded_gs).
//
// Kernels of the port's own choice: the JAX package runs both as XLA
// (raytracer_tpu/ops/banded.py: the body of _solve_banded_jit, and one
// direction of _solve_banded_gs_jit's sweep with its merge), with no
// Pallas kernel.  Python wrappers, tables and plain PyTorch twins:
// raytracer_tpu_torch/ops/banded.py (banded_step, banded_gs, tap_lists,
// banded_step_reference, banded_gs_reference); the halo groups:
// ops/graph.halo_by_destination.
//
// What they compute.  Fields (S, n_pad) float32 or float64 (one template
// build a type) in the permuted order.  The JAX package keeps the weights
// as dense diagonals, W[o][i] the weight of edge (i+o -> i), +inf where no
// edge exists; the kernels read the finite entries of each row as a tap
// list, CSR by row (toff (n_pad+1), tcol the source row i+o, tw the
// weight).  A +inf tap never wins a minimum, each candidate is one
// __fadd_rn / __dadd_rn and the minimum does not depend on order, so the
// floats are those of the dense rolls.
//   banded_jacobi_kernel (banded_sweep): up to `count` iterations of
//     the JAX package's loop in one cooperative launch.  While changed
//     && it < max_iters (the flag and it as the host would read them,
//     the same in every thread), an iteration writes v = min(src[i],
//     src[tcol[t]] + tw[t] over row i's taps) (jnp.minimum(dist,
//     _banded_sweep(dist))) of every (field, row); a halo destination
//     (didx[i] >= 0) also takes the same swept value of each of its
//     sources (the scatter-min reads every source after the sweep and
//     before any write: the thread sweeps the source rows itself, from
//     src); the changed flag is any v < src[i].  The field ping-pongs
//     between out (even iterations) and tmp (odd ones); src is dist0 for
//     the first.  A grid sync ends each iteration; every thread then
//     reads its flag while the next iteration's window comes in (one of
//     three flags: a flag is zeroed two syncs after its last read and set
//     before the next sync).  When no iteration runs, out gets dist0 and
//     it_out, changed_out the inputs.
//   banded_gs (one direction), a block of threads a field: the row
//     blocks of B rows strictly in order (ascending when forward); P
//     passes a block, each a Jacobi update of the block over its rows'
//     taps that reads the block's rows as they stood at the pass's start
//     and a row outside as it stood when the block began: the output for
//     a block already done in this direction, din for one not yet
//     reached; then the block's rows go to the output.  halo_min_kernel
//     then copies the field with each halo destination's minimum over
//     itself and its sources (every source read from the copy before the
//     merge).  Two routes, chosen by ops/banded.gs_plan from the shapes:
//     gs_window_kernel (below) where its window and tap buffers fit a
//     block's shared memory, gs_wide_kernel otherwise.
//
// What bounds them on an H100.  On the production Delaunay annulus
// (47,616 rows, 496,032 finite taps, mean 10.4 a row) a Jacobi iteration
// reads the taps once (~4 MB in float32 with their rows and offsets) and
// the field: ~0.0012 ms at 3.35 TB/s.  The solve is 214 such iterations,
// each depending on the last.  Its first design launched one kernel an
// iteration (a thread a (field, row) walking its taps as dependent
// global loads): 0.0055 ms on the card, a launch's latency, and ~0.03 ms
// of the wrapper's Python an iteration, 216 launches a solve.  The
// Gauss-Seidel direction is a chain of NB x P = 93 x 2 = 186 dependent
// phases on one SM a field: latency, not bandwidth.  Its first design
// (gs_wide_kernel, now the wide-band route) walked every tap as a chain
// of dependent global loads (toff, tcol, the source row from in or out,
// tw), an L2 round trip each: 0.77 ms a direction, ~4.1 us a phase.
//
// banded_jacobi_kernel runs the whole solve in one launch: the grid is
// one block of 512 threads an SM (two blocks of 256 an SM took 7 % longer:
// twice the blocks at each grid sync) and a grid sync separates the
// iterations.  On its shared route (ops/banded.jacobi_plan, where it
// fits) block b owns rows [b R, b R + R) of every field and keeps in
// shared memory, for the whole launch, its rows' taps (laid out by
// ops/banded.jacobi_layout as the window route's blocks: rows sorted by
// tap count onto thread slots, 32 a group padded to the group's widest,
// tap k of lane l at slot 32 k + l, each a uint16 window slot and a
// weight) and, each iteration, its window of the field: the rows
// [lo, hi) its own rows and their taps reach (the band), read from L2
// with coalesced loads.  An iteration's gathers then touch only shared
// memory.  Where the window and taps do not fit, the global route walks
// the tap lists from L2 as the first design did, a thread an item over
// the resident grid.  The field is read through L2 (__ldcg): a buffer
// another block wrote in the last iteration may sit stale in L1.
//
// The window route (gs_window_kernel) takes every global load off that
// chain.  With K the band's reach (the largest |offset|), block [b, b+B)
// reads rows [b - K, b + B + K) only.  Shared memory holds
//   - a ring of Wr rows (2K + 2B rounded up to a power of 2; row j in slot
//     j mod Wr): the window
//     and the rows the next block adds, loaded from din by cp.async one
//     block ahead; a block's rows, once done, stay in the ring (its
//     result is what later blocks read), so out is never read back;
//   - the block's taps, laid out once on the host (ops/banded.gs_layout)
//     and streamed by cp.async one block ahead into a double buffer: the
//     block's rows sorted by tap count, 32 rows (a warp) a group padded
//     to the group's largest count, tap k of the group's lane l at slot
//     32 k + l (conflict-free reads), each a ring slot (int16) and a
//     weight (padding: the row's own slot and +inf, which never wins);
//     per thread slot its row and its group's start and width;
//   - the pass's new values (B rows).
// A pass then reads only shared memory: the taps and the ring, into
// registers (eight taps' loads ahead of their minima, two running minima),
// then a block barrier, the new values into the ring, and a barrier.  The wide route keeps the first design: for a band as wide as
// order="natural" gives, rows out of the window's reach come from global
// memory, and the block's two row buffers sit in shared memory where they
// fit, in global memory (one pair a field) where they do not.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace {

namespace cg = cooperative_groups;

using minplus::add_rn;
using minplus::min_of;
using minplus::pos_inf;

constexpr int kThreads = 256;
constexpr int kGsMaxThreads = 1024;
constexpr int kJacobiThreads = 512;  // one Jacobi block an SM
constexpr int kBatch = 8;            // the Jacobi window's loads in flight a thread

// min(d[r], d[tcol[t]] + tw[t] over row r's taps), the field read
// through L2 (the Jacobi kernel's buffers change within a launch)
template <typename T>
__device__ __forceinline__ T swept_cg(const T* d, int r, const int* __restrict__ toff,
                                      const int* __restrict__ tcol, const T* __restrict__ tw) {
  T v = __ldcg(d + r);
  const int t1 = __ldg(toff + r + 1);
  for (int t = __ldg(toff + r); t < t1; ++t)
    v = min_of(v, add_rn(__ldcg(d + __ldg(tcol + t)), __ldg(tw + t)));
  return v;
}

// The Jacobi solve's shared-route layout in shared memory (ops/banded.
// jacobi_plan): the window (S fields x Wmax rows), the thread slots'
// metadata (R int2, R a multiple of 32), the weights and the window
// slots (nmax each);
// every region a multiple of 16 bytes.
__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

template <typename T>
struct JacobiSmem {
  size_t win, meta, w, idx, end;  // byte offsets
  __host__ __device__ JacobiSmem(int S, int Wmax, int R, int nmax) {
    win = 0;
    meta = align16(static_cast<size_t>(S) * Wmax * sizeof(T));
    w = meta + align16(static_cast<size_t>(R) * sizeof(int2));
    idx = w + align16(static_cast<size_t>(nmax) * sizeof(T));
    end = idx + align16(static_cast<size_t>(nmax) * sizeof(unsigned short));
  }
};

template <typename T>
struct JacobiArgs {
  const T* dist0;  // (S, n_pad), untouched
  T* out;          // (S, n_pad): iterations 0, 2, 4, ... write here
  T* tmp;          // (S, n_pad): iterations 1, 3, ... (unused when count is 1)
  const int* toff;
  const int* tcol;
  const T* tw;  // the tap lists (the global route; halo sources on both)
  const int* didx;
  const int* hoff;
  const int* hsrc;
  const int2* meta;           // shared route: (blocks, R), a slot a row
  const unsigned short* idx;  // shared route: the source row's window slot
  const T* w;                 // shared route: the weights
  const int* blk;             // shared route: (blocks + 1) tap starts
  const int* win;             // shared route: (blocks, 2) window rows [lo, hi)
  const int* it_in;
  const int* changed_in;
  int* it_out;
  int* changed_out;
  int* flags;  // 3 ints, zeroed by the caller
  int S, n_pad, max_iters, count, R, nmax, Wmax;
};

// `count` Jacobi iterations at most (see the head of this file): while
// changed && it < max_iters, one iteration from src to dst, a grid sync,
// the flag read by every thread.  kShared: the block's rows [b R, b R +
// R), its taps and its window of the field in shared memory; else a
// thread a (field, row) over the whole grid, everything from L2.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kJacobiThreads, 1) banded_jacobi_kernel(JacobiArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool lead = blockIdx.x == 0 && tid == 0;
  const JacobiSmem<T> L(a.S, a.Wmax, a.R, a.nmax);
  T* win = reinterpret_cast<T*>(smem_raw + L.win);
  int2* meta = reinterpret_cast<int2*>(smem_raw + L.meta);
  T* wt = reinterpret_cast<T*>(smem_raw + L.w);
  unsigned short* ix = reinterpret_cast<unsigned short*>(smem_raw + L.idx);
  const int r0 = blockIdx.x * a.R;
  int lo = 0, W = 0;
  if (kShared) {  // the block's taps, once a launch
    lo = a.win[2 * blockIdx.x];
    W = a.win[2 * blockIdx.x + 1] - lo;
    const int t0 = a.blk[blockIdx.x], nt = a.blk[blockIdx.x + 1] - t0;
    for (int i = tid; i < a.R; i += nth) meta[i] = a.meta[static_cast<size_t>(blockIdx.x) * a.R + i];
    for (int i = tid; i < nt; i += nth) {
      wt[i] = a.w[t0 + i];
      ix[i] = a.idx[t0 + i];
    }
  }
  const long long total = static_cast<long long>(a.S) * a.n_pad;
  int it = *a.it_in;
  bool changed = *a.changed_in != 0;
  int s = 0;
  for (;;) {
    const bool go = s < a.count && it < a.max_iters;
    // the last iteration's flag, read while this iteration's window comes
    // in (the window of an iteration that does not run is dropped)
    if (s > 0) changed = *reinterpret_cast<volatile int*>(a.flags + (s - 1) % 3) != 0;
    const T* src = s == 0 ? a.dist0 : ((s & 1) ? a.out : a.tmp);
    T* dst = (s & 1) ? a.tmp : a.out;
    if (kShared && go)  // kBatch loads in flight a thread, then their stores
      for (int q0 = tid; q0 < a.S * W; q0 += kBatch * nth) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + u * nth, f = q / W, r = q - f * W;
          if (q < a.S * W) v[u] = __ldcg(src + static_cast<size_t>(f) * a.n_pad + lo + r);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + u * nth, f = q / W, r = q - f * W;
          if (q < a.S * W) win[f * a.Wmax + r] = v[u];
        }
      }
    if (!(go && changed)) break;  // the same in every thread
    // the flag of the next iteration: every thread read it two grid
    // syncs ago, nobody writes it before the next one
    if (lead) a.flags[(s + 1) % 3] = 0;
    bool any = false;
    if (kShared) {
      __syncthreads();
      for (int q = tid; q < a.S * a.R; q += nth) {
        const int f = q / a.R, t = q - f * a.R;
        const int2 m = meta[t];
        if (m.x < 0) continue;
        const int row = r0 + m.x;
        const T* wf = win + f * a.Wmax;
        const T x = wf[row - lo];
        T v0 = x, v1 = pos_inf<T>();
        const int D = m.y >> 20, st = m.y & 0xfffff;
        int k = 0;
        for (; k + 2 <= D; k += 2) {
          v0 = min_of(v0, add_rn(wf[ix[st + 32 * k]], wt[st + 32 * k]));
          v1 = min_of(v1, add_rn(wf[ix[st + 32 * k + 32]], wt[st + 32 * k + 32]));
        }
        if (k < D) v0 = min_of(v0, add_rn(wf[ix[st + 32 * k]], wt[st + 32 * k]));
        T v = min_of(v0, v1);
        const int g = __ldg(a.didx + row);
        if (g >= 0) {
          const T* d0 = src + static_cast<size_t>(f) * a.n_pad;
          for (int h = __ldg(a.hoff + g); h < __ldg(a.hoff + g + 1); ++h)
            v = min_of(v, swept_cg(d0, __ldg(a.hsrc + h), a.toff, a.tcol, a.tw));
        }
        dst[static_cast<size_t>(f) * a.n_pad + row] = v;
        any |= v < x;
      }
    } else {
      const long long nthg = static_cast<long long>(gridDim.x) * nth;
      for (long long e = static_cast<long long>(blockIdx.x) * nth + tid; e < total; e += nthg) {
        const int f = static_cast<int>(e / a.n_pad);
        const int i = static_cast<int>(e - static_cast<long long>(f) * a.n_pad);
        const T* d0 = src + static_cast<size_t>(f) * a.n_pad;
        const T x = __ldcg(d0 + i);
        T v = swept_cg(d0, i, a.toff, a.tcol, a.tw);
        const int g = __ldg(a.didx + i);
        if (g >= 0)
          for (int h = __ldg(a.hoff + g); h < __ldg(a.hoff + g + 1); ++h)
            v = min_of(v, swept_cg(d0, __ldg(a.hsrc + h), a.toff, a.tcol, a.tw));
        dst[e] = v;
        any |= v < x;
      }
    }
    if (__syncthreads_or(any) && tid == 0) *reinterpret_cast<volatile int*>(a.flags + s % 3) = 1;
    grid.sync();
    ++it;
    ++s;
  }
  // the result into out: no iteration ran (dist0), or the last one wrote tmp
  if ((s & 1) == 0) {
    const T* res = s == 0 ? a.dist0 : a.tmp;
    const long long nthg = static_cast<long long>(gridDim.x) * nth;
    for (long long e = static_cast<long long>(blockIdx.x) * nth + tid; e < total; e += nthg)
      a.out[e] = __ldcg(res + e);
  }
  if (lead) {
    *a.it_out = it;
    *a.changed_out = changed ? 1 : 0;
  }
}

// The wide-band route: rows out of the block read from global memory;
// the block's rows twice (the pass's snapshot and its result) in `rowbuf`,
// shared memory or, where 2 B values do not fit it, a global pair a field.
template <typename T>
__global__ void __launch_bounds__(kGsMaxThreads)
    gs_wide_kernel(const T* __restrict__ din, T* __restrict__ dout,
                   const int* __restrict__ toff, const int* __restrict__ tcol,
                   const T* __restrict__ tw, T* __restrict__ gbuf, int n_pad, int B, int P,
                   int forward) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf0 = gbuf ? gbuf + static_cast<size_t>(blockIdx.x) * 2 * B : reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + B;
  const T* in = din + static_cast<size_t>(blockIdx.x) * n_pad;
  T* out = dout + static_cast<size_t>(blockIdx.x) * n_pad;
  const int NB = n_pad / B;
  for (int g = 0; g < NB; ++g) {
    const int r0 = (forward ? g : NB - 1 - g) * B;
    const int r1 = r0 + B;
    for (int i = threadIdx.x; i < B; i += blockDim.x) buf0[i] = in[r0 + i];
    __syncthreads();
    T* cur = buf0;
    T* nxt = buf1;
    for (int p = 0; p < P; ++p) {
      for (int i = threadIdx.x; i < B; i += blockDim.x) {
        const int r = r0 + i;
        T v = cur[i];
        const int t1 = toff[r + 1];
        for (int t = toff[r]; t < t1; ++t) {
          const int j = tcol[t];
          T src;
          if (j >= r0 && j < r1)
            src = cur[j - r0];
          else if (forward ? j < r0 : j >= r1)
            src = out[j];  // a block already written in this direction
          else
            src = in[j];   // a block not reached yet
          v = min_of(v, add_rn(src, tw[t]));
        }
        nxt[i] = v;
      }
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int i = threadIdx.x; i < B; i += blockDim.x) out[r0 + i] = cur[i];
    __syncthreads();
  }
}

// The window route's shared memory (ops/banded.gs_plan): the ring (Wr
// values), the pass's new values (B), then two tap buffers, each the
// per-slot metadata (G32 int2), the weights and the ring slots (nmax
// each); every region a multiple of 16 bytes.

template <typename T>
struct GsSmem {
  size_t ring, nxt, meta, w, idx, buf;  // byte offsets; buf: one tap buffer
  __host__ __device__ GsSmem(int Wr, int B, int G32, int nmax) {
    ring = 0;
    nxt = align16(static_cast<size_t>(Wr) * sizeof(T));
    meta = nxt + align16(static_cast<size_t>(B) * sizeof(T));
    w = static_cast<size_t>(G32) * sizeof(int2);
    idx = w + static_cast<size_t>(nmax) * sizeof(T);
    buf = align16(idx + static_cast<size_t>(nmax) * sizeof(short));
  }
  __host__ __device__ size_t total() const { return meta + 2 * buf; }
};

// The window route (see the head of this file).  meta (NB, G32) int2: a
// thread slot's row in the block (-1: none) and (its first tap's slot |
// its group's width << 20); idx (int16 ring slots) and tw the taps, block
// rb's at [blk[rb], blk[rb+1]), a multiple of 32 each; Wr a power of 2.
template <typename T>
__global__ void __launch_bounds__(kGsMaxThreads)
    gs_window_kernel(const T* __restrict__ din, T* __restrict__ dout,
                     const int2* __restrict__ meta, const short* __restrict__ idx,
                     const T* __restrict__ tw, const int* __restrict__ blk, int n_pad, int B,
                     int P, int forward, int K, int Wr, int G32, int nmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GsSmem<T> L(Wr, B, G32, nmax);
  T* ring = reinterpret_cast<T*>(smem_raw + L.ring);
  T* nxt = reinterpret_cast<T*>(smem_raw + L.nxt);
  const T* in = din + static_cast<size_t>(blockIdx.x) * n_pad;
  T* out = dout + static_cast<size_t>(blockIdx.x) * n_pad;
  const int NB = n_pad / B;
  const int nth = blockDim.x;
  const int wm = Wr - 1;  // row j in ring slot j & wm
  const auto tap_buf = [&](int q) { return smem_raw + L.meta + (q & 1) * L.buf; };
  // rows [lo, hi) of din (within [0, n_pad)) into their ring slots
  const auto stage_rows = [&](int lo, int hi) {
    lo = max(lo, 0);
    hi = min(hi, n_pad);
    for (int j = lo + threadIdx.x; j < hi; j += nth) cp_async_ca<sizeof(T)>(ring + (j & wm), in + j);
  };
  // row block rb's metadata and taps ([t0, t1) of idx and tw) into tap
  // buffer q & 1, 16 bytes a copy
  const auto stage_taps = [&](int q, int rb, int t0, int t1) {
    unsigned char* dst = tap_buf(q);
    const int n = t1 - t0;
    const auto copy = [&](unsigned char* d, const void* s, int bytes) {
      const unsigned char* sb = static_cast<const unsigned char*>(s);
      for (int e = 16 * threadIdx.x; e < bytes; e += 16 * nth) cp_async16(d + e, sb + e);
    };
    copy(dst, meta + static_cast<size_t>(rb) * G32, G32 * static_cast<int>(sizeof(int2)));
    copy(dst + L.w, tw + t0, n * static_cast<int>(sizeof(T)));
    copy(dst + L.idx, idx + t0, n * static_cast<int>(sizeof(short)));
  };
  const auto rb_of = [&](int q) { return forward ? q : NB - 1 - q; };
  const int rb0 = rb_of(0);
  stage_rows(rb0 * B - K, rb0 * B + B + K);
  stage_taps(0, rb0, __ldg(blk + rb0), __ldg(blk + rb0 + 1));
  cp_async_commit();
  // the next block's tap range, read a block ahead (off the staging's path)
  int n0 = 0, n1 = 0;
  if (NB > 1) {
    n0 = __ldg(blk + rb_of(1));
    n1 = __ldg(blk + rb_of(1) + 1);
  }
  for (int q = 0; q < NB; ++q) {
    const int b = rb_of(q) * B;
    cp_async_wait_all();
    __syncthreads();  // this block's taps and window are in; the last block's rows too
    if (q + 1 < NB) {  // the next block's taps and the rows its window adds
      if (forward)
        stage_rows(b + B + K, b + 2 * B + K);
      else
        stage_rows(b - B - K, b - K);
      stage_taps(q + 1, rb_of(q + 1), n0, n1);
      cp_async_commit();
      if (q + 2 < NB) {
        n0 = __ldg(blk + rb_of(q + 2));
        n1 = __ldg(blk + rb_of(q + 2) + 1);
      }
    }
    const unsigned char* buf = tap_buf(q);
    const int2* mt = reinterpret_cast<const int2*>(buf);
    const T* wt = reinterpret_cast<const T*>(buf + L.w);
    const short* it = reinterpret_cast<const short*>(buf + L.idx);
    for (int p = 0; p < P; ++p) {
      for (int t = threadIdx.x; t < G32; t += nth) {
        const int2 m = mt[t];
        if (m.x < 0) continue;
        const int D = m.y >> 20;
        const short* ip = it + (m.y & 0xfffff);
        const T* wp = wt + (m.y & 0xfffff);
        // two running minima and eight taps' loads ahead of their use
        T v0 = ring[(b + m.x) & wm], v1 = pos_inf<T>();
        int k = 0;
        for (; k + 8 <= D; k += 8) {
          int j[8];
          T w[8], r[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            j[u] = ip[32 * (k + u)];
            w[u] = wp[32 * (k + u)];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) r[u] = ring[j[u]];
#pragma unroll
          for (int u = 0; u < 8; u += 2) {
            v0 = min_of(v0, add_rn(r[u], w[u]));
            v1 = min_of(v1, add_rn(r[u + 1], w[u + 1]));
          }
        }
        for (; k < D; ++k) v0 = min_of(v0, add_rn(ring[ip[32 * k]], wp[32 * k]));
        nxt[m.x] = min_of(v0, v1);
      }
      __syncthreads();
      const bool last = p + 1 == P;
      for (int t = threadIdx.x; t < G32; t += nth) {
        const int r = mt[t].x;
        if (r < 0) continue;
        const T v = nxt[r];
        ring[(b + r) & wm] = v;
        if (last) out[b + r] = v;
      }
      if (!last) __syncthreads();
    }
    if (P == 0)  // the block's rows out as they came in
      for (int t = threadIdx.x; t < G32; t += nth) {
        const int r = mt[t].x;
        if (r >= 0) out[b + r] = ring[(b + r) & wm];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_min_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ didx,
                    const int* __restrict__ hoff, const int* __restrict__ hsrc, int S,
                    int n_pad) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(S) * n_pad) return;
  const int b = static_cast<int>(idx / n_pad);
  const int i = static_cast<int>(idx - static_cast<long long>(b) * n_pad);
  const T* xb = x + static_cast<size_t>(b) * n_pad;
  T v = xb[i];
  const int g = didx[i];
  if (g >= 0)
    for (int h = hoff[g]; h < hoff[g + 1]; ++h) v = min_of(v, xb[hsrc[h]]);
  y[idx] = v;
}

unsigned grid_of(int S, int n_pad) {
  return static_cast<unsigned>((static_cast<long long>(S) * n_pad + kThreads - 1) / kThreads);
}

// The most blocks of the Jacobi kernel resident at once with `smem`
// bytes of dynamic shared memory (the cooperative launch's limit).
template <typename T, bool kShared>
int jacobi_capacity(int smem, int& blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(banded_jacobi_kernel<T, kShared>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, banded_jacobi_kernel<T, kShared>,
                                                      kJacobiThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  blocks = per_sm * sms;
  return 0;
}

template <typename T, bool kShared>
int launch_jacobi(JacobiArgs<T> a, int blocks, int smem, cudaStream_t st) {
  int cap = 0;
  const int rc = jacobi_capacity<T, kShared>(smem, cap);
  if (rc) return rc;
  if (blocks < 1 || blocks > cap) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(reinterpret_cast<void*>(banded_jacobi_kernel<T, kShared>),
                                  dim3(blocks), dim3(kJacobiThreads), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halo_after(const T* swept, void* dout, const void* didx, const void* hoff, const void* hsrc,
               int n_dest, int S, int n_pad, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_dest == 0) return static_cast<int>(e);
  halo_min_kernel<T><<<grid_of(S, n_pad), kThreads, 0, st>>>(
      swept, static_cast<T*>(dout), static_cast<const int*>(didx),
      static_cast<const int*>(hoff), static_cast<const int*>(hsrc), S, n_pad);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem, int& done) {
  if (smem > 48 * 1024 && smem > done) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = smem;
  }
  return 0;
}

int gs_threads(int rows) { return rows >= kGsMaxThreads ? kGsMaxThreads : ((rows + 31) / 32) * 32; }

template <typename T>
int launch_wide(const void* din, void* dtmp, void* dout, const void* toff, const void* tcol,
                const void* tw, const void* didx, const void* hoff, const void* hsrc, void* gbuf,
                int n_dest, int S, int n_pad, int B, int P, int forward, int smem,
                cudaStream_t st) {
  if (gbuf ? smem != 0 : static_cast<size_t>(smem) != 2 * static_cast<size_t>(B) * sizeof(T))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  const int rc = set_smem(gs_wide_kernel<T>, smem, smem_set);
  if (rc) return rc;
  T* swept_out = static_cast<T*>(n_dest > 0 ? dtmp : dout);
  gs_wide_kernel<T><<<S, gs_threads(B), smem, st>>>(
      static_cast<const T*>(din), swept_out, static_cast<const int*>(toff),
      static_cast<const int*>(tcol), static_cast<const T*>(tw), static_cast<T*>(gbuf), n_pad, B,
      P, forward);
  return halo_after<T>(swept_out, dout, didx, hoff, hsrc, n_dest, S, n_pad, st);
}

template <typename T>
int launch_window(const void* din, void* dtmp, void* dout, const void* meta, const void* idx,
                  const void* tw, const void* blk, const void* didx, const void* hoff,
                  const void* hsrc, int n_dest, int S, int n_pad, int B, int P, int forward,
                  int K, int Wr, int G32, int nmax, int smem, cudaStream_t st) {
  if (K < 1 || Wr < 2 * K + 2 * B || Wr > 32768 || (Wr & (Wr - 1)) || G32 < B || G32 % 32 || nmax < 0 ||
      nmax % 32 || static_cast<size_t>(smem) != GsSmem<T>(Wr, B, G32, nmax).total())
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  const int rc = set_smem(gs_window_kernel<T>, smem, smem_set);
  if (rc) return rc;
  T* swept_out = static_cast<T*>(n_dest > 0 ? dtmp : dout);
  gs_window_kernel<T><<<S, gs_threads(G32), smem, st>>>(
      static_cast<const T*>(din), swept_out, static_cast<const int2*>(meta),
      static_cast<const short*>(idx), static_cast<const T*>(tw), static_cast<const int*>(blk),
      n_pad, B, P, forward, K, Wr, G32, nmax);
  return halo_after<T>(swept_out, dout, didx, hoff, hsrc, n_dest, S, n_pad, st);
}

}  // namespace

// Launches up to `count` Jacobi iterations (one cooperative launch of
// `blocks` blocks of 512 threads) on `stream`; returns the CUDA error as
// an int (0 when the launch was accepted).  dist0 (S, n_pad) float32, or
// float64 when is_double, is left untouched; out and tmp (S, n_pad) of
// its type (tmp may be out when count is 1); toff (n_pad+1), tcol, tw
// the tap lists; didx (n_pad), hoff (D+1), hsrc int32 the halo groups
// (tcol, tw and hsrc may be empty); it_in, changed_in, it_out,
// changed_out one int32 each; flags 3 int32, zeroed by the caller.
// shared != 0 takes the shared route: meta (blocks, R) int2, idx
// (uint16) and w the tap layout of ops/banded.jacobi_layout, blk (blocks
// + 1) its tap starts, win (blocks, 2) the window rows, R rows a block,
// smem the bytes JacobiSmem gives; else those are null and 0 and blocks
// threads stride over the (field, row) items.  All contiguous device
// memory.
extern "C" int banded_jacobi_launch(const void* dist0, void* out, void* tmp, const void* toff,
                                    const void* tcol, const void* tw, const void* didx,
                                    const void* hoff, const void* hsrc, const void* meta,
                                    const void* idx, const void* w, const void* blk,
                                    const void* win, const void* it_in, const void* changed_in,
                                    void* it_out, void* changed_out, void* flags, int S,
                                    int n_pad, int max_iters, int count, int shared, int blocks,
                                    int R, int nmax, int Wmax, int smem, int is_double,
                                    void* stream) {
  if (S < 1 || n_pad < 1 || max_iters < 0 || count < 1 || !dist0 || !out || !tmp ||
      (count > 1 && tmp == out) || !toff || !didx || !hoff || !it_in || !changed_in ||
      !it_out || !changed_out || !flags || smem < 0 ||
      static_cast<size_t>(smem) > minplus::kBlockSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (shared) {
    if (!meta || !idx || !w || !blk || !win || R < 32 || R % 32 || nmax < 0 ||
        nmax % 32 || Wmax < 1 || Wmax > 65536 ||
        static_cast<long long>(R) * blocks < n_pad ||
        static_cast<size_t>(smem) != (is_double ? JacobiSmem<double>(S, Wmax, R, nmax).end
                                                : JacobiSmem<float>(S, Wmax, R, nmax).end))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (smem != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto zero) {
    using T = decltype(zero);
    return JacobiArgs<T>{static_cast<const T*>(dist0),
                         static_cast<T*>(out),
                         static_cast<T*>(tmp),
                         static_cast<const int*>(toff),
                         static_cast<const int*>(tcol),
                         static_cast<const T*>(tw),
                         static_cast<const int*>(didx),
                         static_cast<const int*>(hoff),
                         static_cast<const int*>(hsrc),
                         static_cast<const int2*>(meta),
                         static_cast<const unsigned short*>(idx),
                         static_cast<const T*>(w),
                         static_cast<const int*>(blk),
                         static_cast<const int*>(win),
                         static_cast<const int*>(it_in),
                         static_cast<const int*>(changed_in),
                         static_cast<int*>(it_out),
                         static_cast<int*>(changed_out),
                         static_cast<int*>(flags),
                         S, n_pad, max_iters, count, R, nmax, Wmax};
  };
  if (is_double)
    return shared ? launch_jacobi<double, true>(args(0.0), blocks, smem, st)
                  : launch_jacobi<double, false>(args(0.0), blocks, smem, st);
  return shared ? launch_jacobi<float, true>(args(0.0f), blocks, smem, st)
                : launch_jacobi<float, false>(args(0.0f), blocks, smem, st);
}

// Launches one Gauss-Seidel direction on the wide-band route (and, with
// n_dest halo destinations, the merge) on `stream`; returns the CUDA
// error as an int.  din, dout (S, n_pad) and dtmp (the swept field before
// the merge; unused when n_dest is 0) of one type; the tap lists and halo
// groups as for banded_sweep_launch; B divides n_pad; the block's two row
// buffers in shared memory (smem = 2 B sizeof(T) bytes, gbuf null) or in
// gbuf (S, 2, B) of the field's type (smem 0).  One block a field.
extern "C" int banded_gs_launch(const void* din, void* dtmp, void* dout, const void* toff,
                                const void* tcol, const void* tw, const void* didx,
                                const void* hoff, const void* hsrc, void* gbuf, int n_dest,
                                int S, int n_pad, int B, int P, int forward, int smem,
                                int is_double, void* stream) {
  if (S < 1 || n_pad < 1 || B < 1 || n_pad % B != 0 || P < 0 || n_dest < 0 || smem < 0 ||
      static_cast<size_t>(smem) > minplus::kBlockSmem || !din || !dout || (n_dest > 0 && !dtmp) ||
      !toff || !didx || !hoff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_wide<double>(din, dtmp, dout, toff, tcol, tw, didx, hoff, hsrc, gbuf,
                                         n_dest, S, n_pad, B, P, forward, smem, st)
                   : launch_wide<float>(din, dtmp, dout, toff, tcol, tw, didx, hoff, hsrc, gbuf,
                                        n_dest, S, n_pad, B, P, forward, smem, st);
}

// Launches one Gauss-Seidel direction on the window route (and the
// merge, as banded_gs_launch) on `stream`; returns the CUDA error as an
// int.  meta (NB, G32) int2, idx int16 and tw (of the field's type) the
// tap layout of ops/banded.gs_layout, blk (NB+1) int32 its block starts;
// K the band's reach, Wr the ring (a power of 2, 2K + 2B to 32768), G32 the thread
// slots a block (a multiple of 32, >= B), nmax the most taps a block
// holds (a multiple of 32); smem the bytes GsSmem gives.  One block a
// field.
extern "C" int banded_gs_window_launch(const void* din, void* dtmp, void* dout,
                                       const void* meta, const void* idx, const void* tw,
                                       const void* blk, const void* didx, const void* hoff,
                                       const void* hsrc, int n_dest, int S, int n_pad, int B,
                                       int P, int forward, int K, int Wr, int G32, int nmax,
                                       int smem, int is_double, void* stream) {
  if (S < 1 || n_pad < 1 || B < 1 || n_pad % B != 0 || P < 0 || n_dest < 0 || smem < 1 ||
      static_cast<size_t>(smem) > minplus::kBlockSmem || !din || !dout || (n_dest > 0 && !dtmp) ||
      !meta || !idx || !tw || !blk || !didx || !hoff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch_window<double>(din, dtmp, dout, meta, idx, tw, blk, didx, hoff, hsrc, n_dest,
                                     S, n_pad, B, P, forward, K, Wr, G32, nmax, smem, st)
             : launch_window<float>(din, dtmp, dout, meta, idx, tw, blk, didx, hoff, hsrc, n_dest,
                                    S, n_pad, B, P, forward, K, Wr, G32, nmax, smem, st);
}
