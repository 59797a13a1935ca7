// T full Jacobi iterations of the slot-major field (the 'wrapped' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/diag_wrapped.py
// _make_iter_kernel / _iter_call.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/diag_wrapped.py (witer, witer_reference;
// witer_tiles_reference replays this file's work partition).
//
// What it computes.  The field is (Mp, S*NTL) float32 or float64: row m
// is slot m, source block b holds NTL theta lanes (lane l is theta
// l mod nt; the dup = NTL - nt lanes [nt, NTL) duplicate thetas
// 0..dup-1).  It is the transposed form of csrc/titer.cu.  Each iteration
// is
//   1. ring scan along theta (lanes): min-plus steps of span 1, 2, 4, 8,
//      then n_ring steps of span 16, forward (lane l from lane l-s at
//      cost s*ring_f[m]) and then backward (lane l from l+s at cost
//      s*ring_b[m]), never across the block's first or last lane;
//   2. chain scan along slots (rows): steps of span 1, 2, ... then
//      n_chain steps of the repeat span, forward (row m from m-s, window
//      cost cfl) and backward (row m from m+s, cbl), rows wrapping mod Mp
//      onto +inf window costs;
//   3. band sweep over the (dm, dc) diagonals: y[m, l] = min(x[m, l],
//      x[m+dm, l+dc] + w_j[m]), reading +inf for rows outside [0, Mp)
//      and, when dup > 0, for in-block lanes l+dc outside [0, NTL) (the
//      defect lanes); with dup == 0 the lane wraps mod NTL inside the
//      block.  Then the duplicate merge: lanes l < dup also take the band
//      result of lane l+nt, lanes l >= nt that of l-nt;
//   4. the centre fan: cen[b] = min(cen[b], min over the block of
//      field + fan_w), then field = min(field, cen[b] + fan_w).
// Every step reads the values of the step before (Jacobi), as the TPU
// kernel's whole-array rolls do, so the span schedule and every add (one
// __fadd_rn / __dadd_rn a candidate, the costs s * ring by __fmul_rn /
// __dmul_rn) are the TPU kernel's: the results are the same floats.  Min
// does not depend on order, and rounding is monotone, so
// min(a, b) + f == min(a + f, b + f) to the bit: the band may visit a
// row's diagonals in any order and skip those whose weight is +inf, and
// the centre may take its minimum over the band's results before the
// duplicate merge (each merged value is the minimum of band results of
// its own row and block).
//
// What bounds it on an H100.  At 183x63 (Mp = 824, NTL = 256, dup = 73)
// one launch of T = 4 iterations does about 0.44 G add and min
// operations (mostly the 133,576 finite (row, diagonal) weights times
// 256 lanes), ~6.6 us at 67 TFLOP/s f32 (H100 SXM data sheet, for a card
// at its 700 W power limit), and moves about 2.6 MB, ~1 us at 3.35 TB/s:
// operations bound it.  chip_smoke.py recomputes the bound from its
// run's inputs.  The first form of this file (one kernel a phase, 5 a
// iteration; the band one thread a point looping over all 404 diagonals
// with a branch on +inf and the field read through L1/L2, the 73
// duplicate lanes evaluating a second band; the chain on 32 blocks of
// 1,024 threads with a block barrier a step) took 0.89-0.92 ms at 183x63
// S=1 on an NVIDIA H100 80GB HBM3 at a 700 W power limit; this one 0.16
// ms there (tools/chip_kernel_ab.py --kernels witer --breakdown): ring
// 0.03, chain 0.05, band 0.06 ms of device time a launch, the rest the
// gaps between its 13 kernels.  What holds each now is latency more than
// instruction throughput: the chain's column copies and short-span
// steps, the band's window staging before its one wave of blocks.
//
// Design.  Three kernels an iteration on the caller's stream (a launch
// boundary is the sync across the grid), plus one at the end:
//   ring : a row of one source block in the registers of one warp (4 or
//          8 lanes a thread; a block of warps when NTL > 256), a step of
//          span s < 32 is a shuffle from lane l - s or l + s, no barrier.
//          From the second iteration on it first applies the previous
//          iteration's duplicate merge and centre fan to the band's
//          output; the last launch does only that.  Its first launch
//          copies the centre values in.
//   chain: a lane column in the registers of one warp (up to 32 rows a
//          thread, row m in lane m mod 32; a block of warps when Mp >
//          1024, their edge registers passed through shared memory behind
//          a block barrier a step): a step of the repeat span 32 stays in
//          each thread's registers, a shorter one is a shuffle.  The
//          block's kChainCols columns and the window costs come into
//          shared memory by cp.async (a row's columns in one read), and
//          a step's costs into registers before the step.  (A block
//          barrier a step on 32 blocks took 0.26 ms of the launch, a warp
//          a column double buffered in shared memory 0.30, registers with
//          each cost loaded where it is used 0.15.)
//   band : a block takes kBandRows slot rows x LW lanes of one source
//          block, a warp a row, LW / 32 lanes a thread.  The field window
//          (kBandRows + 2 * halo rows x LW + 8 lanes, halo = the
//          stencil's row padding >= max |dm|) comes into shared memory by
//          cp.async; rows outside [0, Mp) hold +inf, and the 4 lanes on
//          each side of the block's edge hold +inf (dup > 0) or the
//          wrapped lanes (dup == 0).  The rows' finite taps, packed once
//          on the host as (dm, dc, w) lists per row (diag_wrapped.
//          wrapped_tap_lists), come in beside it as (window offset, w):
//          a tap is one shared-memory broadcast of (offset, w) and one
//          shared-memory read a lane, no branch.  Where window and taps
//          do not fit in 227 KB, LW halves to 32; where they do not
//          then either (coarse theta grids, float64), the taps are read
//          from global memory.  The band is evaluated
//          once per lane; the duplicate merge moves to the next ring
//          launch, and each warp folds its row's band + fan_w into the
//          centre by atomicMin on the bits of non-negative floats.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace {

constexpr int kRingRepeat = 16;
constexpr int kRingStatics = 4;   // spans 1, 2, 4, 8
constexpr int kRingWarps = 4;     // one-warp ring strips (rows) a block
constexpr int kChainCols = 4;     // one-warp chain columns a block
constexpr size_t kChainSmemTarget = 96 * 1024;
constexpr int kBandRows = 8;      // rows (warps) of a band block
constexpr int kBandLpt = 2;       // lanes a band thread: 64-lane tiles
constexpr int kLaneHalo = 4;      // window lanes each side of a band tile
constexpr size_t kSmemBudget = 227 * 1024;

using minplus::add_rn;
using minplus::atomic_min_nonneg;
using minplus::is_inf;
using minplus::min_of;
using minplus::mul_rn;
using minplus::pos_inf;
using minplus::warp_min;

// One Jacobi min-plus step along a strip of values held in registers:
// nw warps (this is warp w), R values a thread, value i = (w * R + k) *
// 32 + lane in register k.  Every value takes min(v[i], v[i -+ s] +
// cost(k)) from the values before the step (fwd: i - s, else i + s),
// nothing from outside the strip (its ends read +inf); s <= 32.  With
// nw > 1 the block is the strip: each step passes the warps' edge
// registers through `xchg` (2 * nw * 32 values, alternate halves by
// `parity`) behind one block barrier.
template <typename T, int R, typename Cost>
__device__ __forceinline__ void strip_step(T (&v)[R], int s, bool fwd, int lane, int w, int nw,
                                           T* xchg, int& parity, Cost cost) {
  T bnd = pos_inf<T>();  // the register before k = 0 (fwd) or after k = R - 1
  if (nw > 1) {
    T* slot = xchg + parity * nw * 32;
    parity ^= 1;
    slot[w * 32 + lane] = fwd ? v[R - 1] : v[0];
    __syncthreads();
    const int nb = fwd ? w - 1 : w + 1;
    if (nb >= 0 && nb < nw) bnd = slot[nb * 32 + lane];
  }
  if (s == 32) {  // the same lane, one register over
    if (fwd) {
#pragma unroll
      for (int k = R - 1; k >= 0; --k) v[k] = min_of(v[k], add_rn(k ? v[k - 1] : bnd, cost(k)));
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k)
        v[k] = min_of(v[k], add_rn(k < R - 1 ? v[k + 1] : bnd, cost(k)));
    }
    return;
  }
  const int src = (fwd ? lane - s : lane + s) & 31;
  const bool carry = fwd ? lane < s : lane + s >= 32;  // from the register over
  // register k's candidate is lane src's register k, or k -+ 1 on carry:
  // visit k away from the carry so that `prev` holds the shuffled
  // register before v[k] changes
  T prev = __shfl_sync(0xffffffffu, bnd, src);
  if (fwd) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const T x = __shfl_sync(0xffffffffu, v[k], src);
      v[k] = min_of(v[k], add_rn(carry ? prev : x, cost(k)));
      prev = x;
    }
  } else {
#pragma unroll
    for (int k = R - 1; k >= 0; --k) {
      const T x = __shfl_sync(0xffffffffu, v[k], src);
      v[k] = min_of(v[k], add_rn(carry ? prev : x, cost(k)));
      prev = x;
    }
  }
}

// grid (rows / block, s): the rows of one source block, ntl lanes a
// strip of nw warps, R lanes a thread (a block holds kRingWarps one-warp
// strips when nw == 1, else one strip).  src -> dst, optionally (merge)
// the duplicate merge and centre fan of the previous iteration's band
// output first, then (ring) the ring scan; (copy_cen) cen_out = cen_in.
template <typename T, int R>
__global__ void ring_kernel(const T* __restrict__ src, T* __restrict__ dst,
                            const T* __restrict__ cen_in, T* cen_out,
                            const T* __restrict__ fan, const T* __restrict__ rf,
                            const T* __restrict__ rb, int mp, int ntl, int ntlt, int nt,
                            int n_ring, int nw, bool merge, bool ring, bool copy_cen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xchg = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (copy_cen && blockIdx.x == 0 && threadIdx.x == 0) cen_out[b] = cen_in[b];
  const int warp = threadIdx.x >> 5;
  const int m = nw == 1 ? blockIdx.x * kRingWarps + warp : blockIdx.x;
  const int sw = nw == 1 ? 0 : warp;  // the warp's place in the strip
  if (m >= mp) return;  // the whole strip, so no barrier is left waiting
  const size_t base = static_cast<size_t>(m) * ntlt + static_cast<size_t>(b) * ntl;
  const int l0 = sw * R * 32 + lane;
  T v[R];
  if (merge) {
    const int dup = ntl - nt;
    const T f = add_rn(cen_out[b], fan[m]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int l = l0 + 32 * k;
      T y = src[base + l];
      if (l < dup) y = min_of(y, src[base + l + nt]);
      if (l >= nt) y = min_of(y, src[base + l - nt]);
      v[k] = min_of(y, f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = src[base + l0 + 32 * k];
  }
  if (ring) {
    int parity = 0;
    const int n_steps = kRingStatics + n_ring;
    for (int dir = 0; dir < 2; ++dir) {
      const T cost = dir == 0 ? rf[m] : rb[m];
      for (int k = 0; k < n_steps; ++k) {
        const int s = k < kRingStatics ? (1 << k) : kRingRepeat;
        const T cs = mul_rn(static_cast<T>(s), cost);
        strip_step<T, R>(v, s, dir == 0, lane, sw, nw, xchg, parity, [cs](int) { return cs; });
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) dst[base + l0 + 32 * k] = v[k];
}

// grid (ntlt / cols): the chain scan of the lane columns in place, mp
// rows a strip of nw warps, R rows a thread; rows past mp hold +inf.  A
// row m < s (forward) or m >= mp - s (backward) would wrap mod mp onto a
// window cost of +inf, which no candidate survives: the strip's ends read
// +inf instead.  The block's `cols` columns (one a warp when nw == 1,
// else one on nw warps) pass through shared memory in and out, so that a
// row's cols values are one contiguous read; with `stage` the window
// costs cfl and cbl come into shared memory too, once a block.
template <typename T, int R>
__global__ void chain_kernel(T* x, const T* __restrict__ cfl, const T* __restrict__ cbl, int mp,
                             int ntlt, int nw, int cols, int n_statics, int rep, int n_chain,
                             bool stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = n_statics + 1;  // window-cost rows a direction
  T* xchg = reinterpret_cast<T*>(smem_raw);      // 2 * nw * 32
  T* tile = xchg + 2 * nw * 32;                  // cols x mp, column-major
  T* costs = tile + (static_cast<size_t>(cols) * mp + 1) / 2 * 2;  // 2 x nc x mp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = nw == 1 ? warp : 0;   // the warp's column in the block
  const int sw = nw == 1 ? 0 : warp;  // the warp's place in the strip
  T* x0 = x + static_cast<size_t>(blockIdx.x) * cols;
  // every copy in flight at once (cp.async, no register round trip)
  if (stage) {
    for (int i = threadIdx.x; i < nc * mp; i += blockDim.x) {
      cp_async_ca<sizeof(T)>(costs + i, cfl + i);
      cp_async_ca<sizeof(T)>(costs + nc * mp + i, cbl + i);
    }
  }
  for (int i = threadIdx.x; i < mp * cols; i += blockDim.x) {
    const int m = i / cols, w = i - m * cols;
    cp_async_ca<sizeof(T)>(tile + static_cast<size_t>(w) * mp + m,
                           x0 + static_cast<size_t>(m) * ntlt + w);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const T* cf = stage ? costs : cfl;
  const T* cb = stage ? costs + nc * mp : cbl;
  T* col = tile + static_cast<size_t>(c) * mp;
  const int m0 = sw * R * 32 + lane;
  const T inf = pos_inf<T>();
  T v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int m = m0 + 32 * k;
    v[k] = m < mp ? col[m] : inf;
  }
  // a step's costs come into registers before the step uses them, the
  // repeat span's once a direction
  auto load = [&](const T* ck, T (&cr)[R]) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int m = m0 + 32 * j;
      cr[j] = m < mp ? ck[m] : inf;
    }
  };
  int parity = 0;
  for (int dir = 0; dir < 2; ++dir) {
    const T* cost = dir == 0 ? cf : cb;
    T crep[R];
    load(cost + static_cast<size_t>(n_statics) * mp, crep);
    for (int k = 0; k < n_statics; ++k) {
      T cr[R];
      load(cost + static_cast<size_t>(k) * mp, cr);
      strip_step<T, R>(v, 1 << k, dir == 0, lane, sw, nw, xchg, parity,
                       [&](int j) { return cr[j]; });
    }
    for (int k = 0; k < n_chain; ++k)  // rep <= 32
      strip_step<T, R>(v, rep, dir == 0, lane, sw, nw, xchg, parity,
                       [&](int j) { return crep[j]; });
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int m = m0 + 32 * k;
    if (m < mp) col[m] = v[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mp * cols; i += blockDim.x) {
    const int m = i / cols, w = i - m * cols;
    x0[static_cast<size_t>(m) * ntlt + w] = tile[static_cast<size_t>(w) * mp + m];
  }
}

template <typename T>
struct Tap {
  int off;  // dm * window width + dc
  T w;
};

// grid (ceil(mp / kBandRows), ntl / (32 * LPT), s): the band of kBandRows
// rows x 32 * LPT lanes of one source block, x -> y, and each row's
// min(y + fan) into cen[b].  The block's taps (at most tap_cap) are staged
// in shared memory beside the window; with tap_cap == 0 each is read from
// global memory where it is used (a broadcast through L1).
template <typename T, int LPT>
__global__ void __launch_bounds__(kBandRows * 32)
band_kernel(const T* __restrict__ x, const int* __restrict__ tap_ptr,
            const int* __restrict__ tap_dmdc, const T* __restrict__ tap_w,
            const T* __restrict__ fan, T* __restrict__ y, T* cen, int mp, int ntl, int ntlt,
            bool wrap, int halo, int tap_cap) {
  constexpr int kLW = 32 * LPT;
  constexpr int kWW = kLW + 2 * kLaneHalo;
  constexpr int kVec = 16 / sizeof(T);  // values of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int wrows = kBandRows + 2 * halo;
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(
      smem_raw + (static_cast<size_t>(wrows) * kWW * sizeof(T) + 15) / 16 * 16);
  const int m0 = blockIdx.x * kBandRows;
  const int l0 = blockIdx.y * kLW;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * ntl;

  // the window: row r is slot m0 - halo + r, column q is lane l0 - 4 + q
  const T inf = pos_inf<T>();
  constexpr int kChunks = kWW / kVec;
  for (int i = threadIdx.x; i < wrows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, q = (i - r * kChunks) * kVec;
    const int g = m0 - halo + r;
    int lp = l0 - kLaneHalo + q;
    T* d = win + static_cast<size_t>(r) * kWW + q;
    bool fill = g < 0 || g >= mp;
    if (!fill && (lp < 0 || lp >= ntl)) {
      if (wrap) lp = lp < 0 ? lp + ntl : lp - ntl;
      else fill = true;  // defect lanes: +inf
    }
    if (fill) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) d[v] = inf;
    } else {
      cp_async16(d, xb + static_cast<size_t>(g) * ntlt + lp);
    }
  }
  cp_async_commit();
  // a tap as (offset in the window, weight)
  auto tap_at = [&](int e) {
    const int dmdc = tap_dmdc[e];
    const int dm = dmdc >> 16;                       // arithmetic shift
    const int dc = static_cast<int>(static_cast<short>(dmdc & 0xffff));
    return Tap<T>{dm * kWW + dc, tap_w[e]};
  };
  const int e0 = tap_ptr[min(m0, mp)];
  const int e1 = tap_ptr[min(m0 + kBandRows, mp)];
  for (int e = e0 + threadIdx.x; e < e1 && e - e0 < tap_cap; e += blockDim.x)
    taps[e - e0] = tap_at(e);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = m0 + warp;
  if (m >= mp) return;  // no block barrier below
  const T* c0 = win + static_cast<size_t>(halo + warp) * kWW + kLaneHalo + lane;
  T acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = c0[32 * j];
  auto relax = [&](const Tap<T> t) {
    const T* p = c0 + t.off;
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[j] = min_of(acc[j], add_rn(p[32 * j], t.w));
  };
  if (tap_cap > 0) {
    const int k1 = tap_ptr[m + 1] - e0;
#pragma unroll 4
    for (int k = tap_ptr[m] - e0; k < k1; ++k) relax(taps[k]);
  } else {
    const int e1m = tap_ptr[m + 1];
#pragma unroll 4
    for (int e = tap_ptr[m]; e < e1m; ++e) relax(tap_at(e));
  }
  T* yr = y + static_cast<size_t>(m) * ntlt + static_cast<size_t>(b) * ntl + l0 + lane;
#pragma unroll
  for (int j = 0; j < LPT; ++j) yr[32 * j] = acc[j];
  const T f = fan[m];
  if (!is_inf(f)) {  // the same for the whole warp
    T v = inf;
#pragma unroll
    for (int j = 0; j < LPT; ++j) v = min_of(v, add_rn(acc[j], f));
    v = warp_min(v);
    if (lane == 0 && !is_inf(v)) atomic_min_nonneg(cen + b, v);
  }
}

template <typename T>
size_t band_smem(int lpt, int halo, int tap_cap) {
  const size_t win = static_cast<size_t>(kBandRows + 2 * halo) * (32 * lpt + 2 * kLaneHalo) *
                     sizeof(T);
  return (win + 15) / 16 * 16 + static_cast<size_t>(tap_cap) * sizeof(Tap<T>);
}

template <typename T, int LPT>
cudaError_t launch_band(const T* x, const int* tap_ptr, const int* tap_dmdc, const T* tap_w,
                        const T* fan, T* y, T* cen, int s, int mp, int ntl, int ntlt, bool wrap,
                        int halo, int tap_cap, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(band_kernel<T, LPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((mp + kBandRows - 1) / kBandRows, ntl / (32 * LPT), s);
  band_kernel<T, LPT><<<grid, kBandRows * 32, smem, st>>>(
      x, tap_ptr, tap_dmdc, tap_w, fan, y, cen, mp, ntl, ntlt, wrap, halo, tap_cap);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_chain(T* x, const T* cfl, const T* cbl, int mp, int ntlt, int nw, int cols,
                         int warps, int n_statics, int rep, int n_chain, bool stage, size_t smem,
                         cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  chain_kernel<T, R><<<ntlt / cols, warps * 32, smem, st>>>(x, cfl, cbl, mp, ntlt, nw, cols,
                                                            n_statics, rep, n_chain, stage);
  return cudaGetLastError();
}

template <typename T>
int run(const T* dist, const T* cen, const int* tap_ptr, const int* tap_dmdc, const T* tap_w,
        const T* ring_f, const T* ring_b, const T* cfl, const T* cbl, const T* fan, T* out,
        T* scratch, T* cen_out, int s, int mp, int ntl, int nt, int halo, int block_taps,
        int n_ring, int n_chain_statics, int chain_rep, int n_chain, int iters,
        cudaStream_t st) {
  const int ntlt = s * ntl;
  T* x = out;
  T* y = scratch;
  // ring strips: ntl lanes, 4 or 8 a thread (ntl is a multiple of 128)
  const int ring_r = ntl % 256 ? 4 : 8;
  const int ring_nw = ntl / (32 * ring_r);
  const int ring_warps = ring_nw == 1 ? kRingWarps : ring_nw;
  const dim3 ring_grid(ring_nw == 1 ? (mp + kRingWarps - 1) / kRingWarps : mp, s);
  // chain strips: mp rows, the fewest registers a thread that one warp
  // covers, else 32 a thread on as many warps as it takes
  const int chain_nw = (mp + 1023) / 1024;
  const int chain_r = chain_nw > 1 ? 32 : (mp <= 256 ? 8 : (mp <= 512 ? 16 : (mp <= 768 ? 24 : 32)));
  const int chain_cols = chain_nw == 1 ? kChainCols : 1;
  const int chain_warps = chain_nw == 1 ? kChainCols : chain_nw;
  const size_t ring_smem = 2 * static_cast<size_t>(ring_nw) * 32 * sizeof(T);
  const size_t chain_base = (2 * static_cast<size_t>(chain_nw) * 32 +
                             (static_cast<size_t>(chain_cols) * mp + 1) / 2 * 2) * sizeof(T);
  const size_t chain_costs = 2 * static_cast<size_t>(n_chain_statics + 1) * mp * sizeof(T);
  // the window costs into shared memory where a block holds several
  // columns and they fit
  const bool chain_stage = chain_cols > 1 && chain_base + chain_costs <= kChainSmemTarget;
  const size_t chain_smem = chain_base + (chain_stage ? chain_costs : 0);
  // lanes a band thread (kBandLpt), fewer where the window and the
  // block's taps would not fit; where they do not at one lane either, the
  // taps stay in global memory (diag_circulant.band_tile mirrors this)
  int lpt = kBandLpt;
  int tap_cap = block_taps;
  while (lpt > 1 && band_smem<T>(lpt, halo, tap_cap) > kSmemBudget) lpt /= 2;
  if (band_smem<T>(lpt, halo, tap_cap) > kSmemBudget) {
    tap_cap = 0;
    lpt = kBandLpt;
    while (lpt > 1 && band_smem<T>(lpt, halo, 0) > kSmemBudget) lpt /= 2;
  }
  const size_t bsmem = band_smem<T>(lpt, halo, tap_cap);
  if (ring_warps > 32 || chain_warps > 32 || bsmem > kSmemBudget || chain_smem > kSmemBudget ||
      ntl % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wrap = ntl == nt;
  cudaError_t e;

  auto rows = [&](const T* src, T* dst, bool merge, bool ring, bool copy) {
    if (ring_r == 4)
      ring_kernel<T, 4><<<ring_grid, ring_warps * 32, ring_smem, st>>>(
          src, dst, cen, cen_out, fan, ring_f, ring_b, mp, ntl, ntlt, nt, n_ring, ring_nw,
          merge, ring, copy);
    else
      ring_kernel<T, 8><<<ring_grid, ring_warps * 32, ring_smem, st>>>(
          src, dst, cen, cen_out, fan, ring_f, ring_b, mp, ntl, ntlt, nt, n_ring, ring_nw,
          merge, ring, copy);
    return cudaGetLastError();
  };
  auto chain = [&]() {
    switch (chain_r) {
      case 8: return launch_chain<T, 8>(x, cfl, cbl, mp, ntlt, chain_nw, chain_cols, chain_warps,
                                        n_chain_statics, chain_rep, n_chain, chain_stage,
                                        chain_smem, st);
      case 16: return launch_chain<T, 16>(x, cfl, cbl, mp, ntlt, chain_nw, chain_cols,
                                          chain_warps, n_chain_statics, chain_rep, n_chain,
                                          chain_stage, chain_smem, st);
      case 24: return launch_chain<T, 24>(x, cfl, cbl, mp, ntlt, chain_nw, chain_cols,
                                          chain_warps, n_chain_statics, chain_rep, n_chain,
                                          chain_stage, chain_smem, st);
      default: return launch_chain<T, 32>(x, cfl, cbl, mp, ntlt, chain_nw, chain_cols,
                                          chain_warps, n_chain_statics, chain_rep, n_chain,
                                          chain_stage, chain_smem, st);
    }
  };
  if (iters <= 0) return static_cast<int>(rows(dist, x, false, false, true));
  for (int it = 0; it < iters; ++it) {
    e = it == 0 ? rows(dist, x, false, true, true) : rows(y, x, true, true, false);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((e = chain()) != cudaSuccess) return static_cast<int>(e);
#define WITER_BAND(L)                                                                       \
  launch_band<T, L>(x, tap_ptr, tap_dmdc, tap_w, fan, y, cen_out, s, mp, ntl, ntlt, wrap, halo, \
                    tap_cap, bsmem, st)
    e = lpt == 2 ? WITER_BAND(2) : WITER_BAND(1);
#undef WITER_BAND
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(rows(y, x, true, false, false));
}

}  // namespace

// Runs `iters` iterations on `stream`; returns the first CUDA error as
// an int (0 when every launch was accepted).  dist (mp, s*ntl) and cen
// (s,) are read only; out (mp, s*ntl) and cen_out (s,) receive the
// result; scratch (mp, s*ntl) is work space.  The band's taps, packed
// per row by diag_wrapped.wrapped_tap_lists: tap_ptr (mp+1,) int32 the
// first entry of each row, tap_dmdc (E,) int32 dm << 16 | (dc & 0xffff)
// with |dm| <= halo and |dc| <= 4, tap_w (E,) the weights; block_taps is
// the most entries that kBandRows consecutive rows from a multiple of
// kBandRows hold (diag_wrapped.band_block_taps).  ring_f/ring_b/fan (mp, 1),
// cfl/cbl (n_chain_statics+1, mp, 1) with cfl[k][m] = +inf for m < span k
// and cbl[k][m] = +inf for m >= mp - span k (the spans 1, 2, 4, ...,
// chain_rep <= 32).  All contiguous device memory, float32 (is_double ==
// 0) or float64 apart from the int32 tables; ntl a multiple of 128.
extern "C" int witer_launch(const void* dist, const void* cen, const void* tap_ptr,
                            const void* tap_dmdc, const void* tap_w, const void* ring_f,
                            const void* ring_b, const void* cfl, const void* cbl,
                            const void* fan, void* out, void* scratch, void* cen_out, int s,
                            int mp, int ntl, int nt, int halo, int block_taps, int n_ring,
                            int n_chain_statics, int chain_rep, int n_chain, int iters,
                            int is_double, void* stream) {
  if (s < 1 || mp < 1 || nt < 1 || nt > ntl || halo < 0 || block_taps < 0 || chain_rep > 32 ||
      static_cast<long long>(mp) * s * ntl >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tap_ptr);
  const int* td = static_cast<const int*>(tap_dmdc);
  if (is_double)
    return run<double>(static_cast<const double*>(dist), static_cast<const double*>(cen), tp, td,
                       static_cast<const double*>(tap_w), static_cast<const double*>(ring_f),
                       static_cast<const double*>(ring_b), static_cast<const double*>(cfl),
                       static_cast<const double*>(cbl), static_cast<const double*>(fan),
                       static_cast<double*>(out), static_cast<double*>(scratch),
                       static_cast<double*>(cen_out), s, mp, ntl, nt, halo, block_taps, n_ring,
                       n_chain_statics, chain_rep, n_chain, iters, st);
  return run<float>(static_cast<const float*>(dist), static_cast<const float*>(cen), tp, td,
                    static_cast<const float*>(tap_w), static_cast<const float*>(ring_f),
                    static_cast<const float*>(ring_b), static_cast<const float*>(cfl),
                    static_cast<const float*>(cbl), static_cast<const float*>(fan),
                    static_cast<float*>(out), static_cast<float*>(scratch),
                    static_cast<float*>(cen_out), s, mp, ntl, nt, halo, block_taps, n_ring,
                    n_chain_statics, chain_rep, n_chain, iters, st);
}
