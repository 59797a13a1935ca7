// T Jacobi iterations of the theta-major field (the 'twrapped' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/wrapped_t.py
// _make_titer_kernel / _titer_call.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/wrapped_t.py (titer, titer_reference;
// titer_tiles_reference replays this file's work partition).
//
// What it computes.  The field is (S*NTT, ML) float32 or float64: source
// block b holds NTT theta rows (row t is theta t mod nt; the dup = NTT -
// nt rows [nt, NTT) duplicate thetas 0..dup-1) by ML slot lanes.  It is
// the transposed form of csrc/witer.cu.  Each iteration is
//   1. ring scan along theta (rows): min-plus steps of span 1, 2, 4, 8
//      (those < NTT), then n_ring steps of span 16, forward (row t from
//      row t-s at cost s*ring_f[m]) and then backward (row t from t+s at
//      cost s*ring_b[m]), never across the block's first or last row;
//   2. chain scan along slots (lanes): steps of span 1, 2, ... then
//      n_chain steps of the repeat span, forward (lane m from m-s,
//      window cost cfl) and backward (lane m from m+s, cbl), lanes
//      wrapping mod ML;
//   3. band sweep over the 5 theta-shifted pages (dc = -2..2) and the
//      slot offsets dm in [-maxdm, maxdm]:
//        y[t][m] = min(x[t][m], min over dm, dc of
//                      x[t+dc][(m+dm) mod ML] + wrows[(dm+maxdm)*5 + dc+2][(m+dm) mod ML]),
//      with dup == 0 the row t+dc wrapping mod NTT inside the block, with
//      dup > 0 rows past the block's edge reading +inf; then the
//      duplicate merge: rows t < dup also take the band result of row
//      t+nt, rows t >= nt that of row t-nt;
//   4. the centre fan: cen[b] = min(cen[b], min over the block of
//      field + fan_w), then field = min(field, cen[b] + fan_w).
// Every step reads the values of the step before (Jacobi), as the TPU
// kernel's whole-array rolls do, so the span schedule and every add (one
// __fadd_rn / __dadd_rn a candidate, the costs s * ring by __fmul_rn /
// __dmul_rn) are the TPU kernel's: the results are the same floats.  Min
// does not depend on order, and rounding is monotone, so min(a, b) + f ==
// min(a + f, b + f) to the bit: each row's band is evaluated once (the
// merge is a min of two rows' results), and the centre may take its
// minimum over the band's results before the merge (each merged value is
// the minimum of band results of rows of its own block).
//
// What bounds it on an H100.  At 180x63 (NTT = 184, ML = 896, maxdm = 48
// with band closure 1: 485 taps a point, 71 % of them finite) one launch
// of T = 4 iterations does about 0.6 G add and min operations, ~9 us at
// 67 TFLOP/s f32 (H100 SXM data sheet, for a card at its 700 W power
// limit), and moves about 3 MB, ~1 us at 3.35 TB/s: operations bound it.
// chip_smoke.py recomputes the bound from its run's inputs.  The first
// form of this file (five kernels an iteration and two copies: the ring
// on 28 blocks with a block barrier a step, the chain with a block
// barrier a step, the band one thread a point reading 485 taps and 485
// weights from L1/L2 and the duplicate rows evaluating a second band, the
// fan in two more passes) took 0.61 ms a launch at 180x63 S=1 on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit: ring 0.073, chain 0.101,
// band + merge 0.378, fan 0.020 ms of device time (torch.profiler).
//
// Design: witer.cu's, transposed.  Three kernels an iteration on the
// caller's stream (a launch boundary is the sync across the grid), plus
// one at the end:
//   ring : a lane column of one source block in the registers of one
//          warp (row t in lane t mod 32 of register t / 32, 2, 4 or 8
//          rows a thread, rows past NTT +inf; 32 a thread on a block of
//          warps when NTT > 256, their edge registers passed through
//          shared memory behind a block barrier a step), a step of span
//          s <= 16 one shuffle.  The block's kRingCols columns come into
//          shared memory by cp.async (a row's columns in one read) and go
//          out the same way.  From the second iteration on it first
//          applies the previous iteration's duplicate merge and centre
//          fan to the band's output, reading the partner rows from that
//          tile; the last launch does only that.  Its first launch copies
//          the centre values in.
//   chain: a theta row in the registers of one warp (lane m in lane m
//          mod 32 of register m / 32: exactly ML / 32 lanes a thread, a
//          multiple of 4; a block of warps when ML > 1024), a step of the
//          repeat span 32 stays in each thread's registers, a shorter one
//          is a shuffle; the wrap mod ML is the strip's last register read
//          by its first (and back).  The window costs come into shared
//          memory by cp.async, once a block, and a step's into registers
//          before the step.  Every strip holds exactly its values: a
//          register count known at compile time, no guard a register.
//          (The first form of this file guarded each register by a count
//          known at run time: each guard cut the warp's instruction
//          stream into blocks of one register, and the chain took 0.147
//          ms of a 0.34 ms launch.)
//   band : band.cu's row ring: a block takes kBandLanes lanes of a run of
//          theta rows of one source block, the rows it reads (kBandRows
//          + 4 a step, with maxdm halo lanes each side, wrapped mod ML;
//          +inf or wrapped mod NTT past the block's edge) in a
//          shared-memory ring filled by cp.async; a thread keeps the
//          kBandRows accumulators of its lane, reads each tap's 5
//          weights once (through L1) and each field value once for up to
//          5 outputs.  Each thread folds min(y + fan_w) of its outputs
//          into the centre by atomicMin on the bits of non-negative
//          floats, a warp at a time.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace {

constexpr int kRingRepeat = 16;
constexpr int kRingCols = 8;      // one-warp ring columns a block
constexpr int kChainRows = 2;     // one-warp chain rows a block
constexpr int kNdc = 5;           // theta offsets dc = -2..2
constexpr int kBandLanes = 128;   // output lanes of a band block, one a thread
constexpr int kBandRows = 4;      // theta rows a band step
constexpr int kBandRing = 16;     // ring rows; >= 2 * kBandRows + kNdc - 1
constexpr int kBandBlocksPerSm = 8;
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
// cost(k)) from the values before the step (fwd: i - s, else i + s);
// s <= 32.  The strip's ends read +inf, or with `wrap` each other.  With
// nw > 1 the block is the strip: each step passes the warps' edge
// registers through `xchg` (2 * nw * 32 values, alternate halves by
// `parity`) behind one block barrier.  (witer.cu's strip step, with the
// wrap.)
template <typename T, int R, typename Cost>
__device__ __forceinline__ void strip_step(T (&v)[R], int s, bool fwd, bool wrap, int lane,
                                           int w, int nw, T* xchg, int& parity, Cost cost) {
  // the value before register 0 (fwd) or after register R - 1
  T bnd = pos_inf<T>();
  if (nw > 1) {
    T* slot = xchg + parity * nw * 32;
    parity ^= 1;
    slot[w * 32 + lane] = fwd ? v[R - 1] : v[0];
    __syncthreads();
    int nb = fwd ? w - 1 : w + 1;
    if (wrap) nb = (nb + nw) % nw;
    if (nb >= 0 && nb < nw) bnd = slot[nb * 32 + lane];
  } else if (wrap) {
    bnd = fwd ? v[R - 1] : v[0];
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

// grid (ml / cols, s): the ring scan of lane columns, a strip of nw warps
// and R rows a thread (rows past ntt hold +inf and take no candidate; a
// block holds `cols` one-warp columns when nw == 1, else one column).
// src -> dst through a shared-memory tile of the block's columns (row t
// at t * (cols + 1)); optionally (merge) the duplicate merge and centre
// fan of the previous iteration's band output first, then (ring) the
// scan; (copy_cen) cen_out = cen_in.
template <typename T, int R>
__global__ void ring_kernel(const T* __restrict__ src, T* __restrict__ dst,
                            const T* __restrict__ cen_in, T* cen_out, const T* __restrict__ fan,
                            const T* __restrict__ rf, const T* __restrict__ rb, int ml, int ntt,
                            int nt, int n_statics, int n_ring, int nw, int cols, bool merge,
                            bool ring, bool copy_cen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xchg = reinterpret_cast<T*>(smem_raw);  // 2 * nw * 32
  T* tile = xchg + 2 * nw * 32;              // ntt x (cols + 1)
  const int ts = cols + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  if (copy_cen && blockIdx.x == 0 && threadIdx.x == 0) cen_out[b] = cen_in[b];
  const int c = nw == 1 ? warp : 0;   // the warp's column in the block
  const int sw = nw == 1 ? 0 : warp;  // the warp's place in the strip
  const int m0 = blockIdx.x * cols;
  const size_t base = static_cast<size_t>(b) * ntt * ml + m0;
  for (int i = threadIdx.x; i < ntt * cols; i += blockDim.x) {
    const int t = i / cols, j = i - t * cols;
    cp_async_ca<sizeof(T)>(tile + t * ts + j, src + base + static_cast<size_t>(t) * ml + j);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int m = m0 + c;
  const int t0 = sw * R * 32 + lane;
  const T inf = pos_inf<T>();
  T v[R];
  const int dup = ntt - nt;
  const T f = merge ? add_rn(cen_out[b], fan[m]) : inf;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int t = t0 + 32 * k;
    T y = inf;
    if (t < ntt) {
      y = tile[t * ts + c];
      if (merge) {
        if (t < dup) y = min_of(y, tile[(t + nt) * ts + c]);
        if (t >= nt) y = min_of(y, tile[(t - nt) * ts + c]);
        y = min_of(y, f);
      }
    }
    v[k] = y;
  }
  if (ring) {
    int parity = 0;
    const int n_steps = n_statics + n_ring;
    for (int dir = 0; dir < 2; ++dir) {
      const T cost = dir == 0 ? rf[m] : rb[m];
      for (int k = 0; k < n_steps; ++k) {
        const int s = k < n_statics ? (1 << k) : kRingRepeat;
        const T cs = mul_rn(static_cast<T>(s), cost);
        // rows past ntt stay +inf: they take no candidate
        strip_step<T, R>(v, s, dir == 0, false, lane, sw, nw, xchg, parity,
                         [&](int j) { return t0 + 32 * j < ntt ? cs : inf; });
      }
    }
  }
  __syncthreads();  // every warp has read the tile
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int t = t0 + 32 * k;
    if (t < ntt) tile[t * ts + c] = v[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ntt * cols; i += blockDim.x) {
    const int t = i / cols, j = i - t * cols;
    dst[base + static_cast<size_t>(t) * ml + j] = tile[t * ts + j];
  }
}

// grid (rows / rows_a_block): the chain scan of theta rows in place, ml
// lanes a strip of nw warps, R lanes a thread (ml = nw * 32 * R; a block
// holds kChainRows one-warp rows when nw == 1, else one row); lanes wrap
// mod ml.  A step's window costs (cfl or cbl, row k: span 2^k, the last
// row the repeat span) come into registers before the step, the repeat
// span's once a direction; with `stage` all of them come into shared
// memory first by cp.async, once a block.
template <typename T, int R>
__global__ void chain_kernel(T* x, const T* __restrict__ cfl, const T* __restrict__ cbl, int ml,
                             int nw, int n_statics, int rep, int n_chain, bool stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = n_statics + 1;  // window-cost rows a direction
  T* costs = reinterpret_cast<T*>(smem_raw);        // 2 x nc x ml
  T* xchg = costs + (stage ? 2 * nc * ml : 0);      // 2 * nw * 32
  if (stage) {
    constexpr int kVec = 16 / sizeof(T);
    for (int i = threadIdx.x * kVec; i < nc * ml; i += blockDim.x * kVec) {
      cp_async16(costs + i, cfl + i);
      cp_async16(costs + nc * ml + i, cbl + i);
    }
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = nw == 1 ? blockIdx.x * kChainRows + warp : blockIdx.x;
  const int sw = nw == 1 ? 0 : warp;
  T* xr = x + static_cast<size_t>(row) * ml;
  const int m0 = sw * R * 32 + lane;
  T v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = xr[m0 + 32 * k];
  if (stage) {
    cp_async_wait_all();
    __syncthreads();
  }
  const T* cf = stage ? costs : cfl;
  const T* cb = stage ? costs + nc * ml : cbl;
  auto load = [&](const T* ck, T (&cr)[R]) {
#pragma unroll
    for (int j = 0; j < R; ++j) cr[j] = ck[m0 + 32 * j];
  };
  int parity = 0;
  for (int dir = 0; dir < 2; ++dir) {
    const T* cost = dir == 0 ? cf : cb;
    T crep[R];
    load(cost + static_cast<size_t>(n_statics) * ml, crep);
    for (int k = 0; k < n_statics; ++k) {
      T cr[R];
      load(cost + static_cast<size_t>(k) * ml, cr);
      strip_step<T, R>(v, 1 << k, dir == 0, true, lane, sw, nw, xchg, parity,
                       [&](int j) { return cr[j]; });
    }
    for (int k = 0; k < n_chain; ++k)  // rep <= 32
      strip_step<T, R>(v, rep, dir == 0, true, lane, sw, nw, xchg, parity,
                       [&](int j) { return crep[j]; });
  }
#pragma unroll
  for (int k = 0; k < R; ++k) xr[m0 + 32 * k] = v[k];
}

// ring rows [r0, r0 + n) of a run (run row q is theta row c_begin - 2 + q:
// wrapped mod ntt with wrap, else +inf outside [0, ntt)) into their ring
// slots, lanes m0 - maxdm .. m0 + kBandLanes - 1 + maxdm wrapped mod ml
template <typename T>
__device__ __forceinline__ void band_fill(T* ring, const T* xb, int r0, int n, int c_begin,
                                          int ntt, bool wrap, int ml, int m0, int maxdm,
                                          int width) {
  for (int q = r0; q < r0 + n; ++q) {
    int c = c_begin - 2 + q;
    bool fill = false;
    if (c < 0 || c >= ntt) {
      if (wrap) c = c < 0 ? c + ntt : c - ntt;  // |dc| <= 2 <= ntt
      else fill = true;
    }
    T* d = ring + (q % kBandRing) * width;
    const T* row = xb + static_cast<size_t>(c) * ml;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      if (fill) {
        d[j] = pos_inf<T>();
      } else {
        int lx = (m0 - maxdm + j) % ml;
        if (lx < 0) lx += ml;
        cp_async_ca<sizeof(T)>(d + j, row + lx);
      }
    }
  }
  cp_async_commit();
}

// grid (ml / kBandLanes, runs, s): the band of kBandLanes lanes of a run
// of theta rows of one source block, x -> y, and min(y + fan) of its
// outputs into cen[b].
template <typename T>
__global__ void __launch_bounds__(kBandLanes)
band_kernel(const T* __restrict__ x, const T* __restrict__ wrows, const T* __restrict__ fan,
            T* __restrict__ y, T* cen, int ntt, bool wrap, int ml, int maxdm, int run) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int width = kBandLanes + 2 * maxdm;
  const int m0 = blockIdx.x * kBandLanes;
  const int c_begin = blockIdx.y * run;
  const int c_end = min(ntt, c_begin + run);
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * ntt * ml;
  T* yb = y + static_cast<size_t>(b) * ntt * ml;
  const int lane = threadIdx.x;
  const int m = m0 + lane;
  const int n_dm = 2 * maxdm + 1;
  int x0 = (m - maxdm) % ml;  // the weight lane of tap 0, wrapped
  if (x0 < 0) x0 += ml;
  const T inf = pos_inf<T>();
  const T f = fan[m];
  T fmin = inf;

  const int steps = (c_end - c_begin + kBandRows - 1) / kBandRows;
  band_fill(ring, xb, 0, kBandRows + kNdc - 1, c_begin, ntt, wrap, ml, m0, maxdm, width);
  for (int k = 0; k < steps; ++k) {
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in; the last step is done
    if (k + 1 < steps)
      band_fill(ring, xb, (k + 1) * kBandRows + kNdc - 1, kBandRows, c_begin, ntt, wrap, ml, m0,
                maxdm, width);
    const int rbase = k * kBandRows;  // run row of theta row c_begin + rbase - 2
    T acc[kBandRows];
#pragma unroll
    for (int i = 0; i < kBandRows; ++i)
      acc[i] = ring[((rbase + i + 2) % kBandRing) * width + maxdm + lane];
    int xw = x0;
#pragma unroll 4
    for (int t = 0; t < n_dm; ++t) {
      T w[kNdc];
#pragma unroll
      for (int u = 0; u < kNdc; ++u) w[u] = __ldg(wrows + static_cast<size_t>(t * kNdc + u) * ml + xw);
#pragma unroll
      for (int q = 0; q < kBandRows + kNdc - 1; ++q) {
        const T fv = ring[((rbase + q) % kBandRing) * width + lane + t];
#pragma unroll
        for (int i = 0; i < kBandRows; ++i) {
          const int u = q - i;  // output row i reads run row rbase + i + u
          if (u >= 0 && u < kNdc) acc[i] = min_of(acc[i], add_rn(fv, w[u]));
        }
      }
      xw = (xw + 1 == ml) ? 0 : xw + 1;
    }
#pragma unroll
    for (int i = 0; i < kBandRows; ++i) {
      const int c = c_begin + rbase + i;
      if (c < c_end) {
        yb[static_cast<size_t>(c) * ml + m] = acc[i];
        if (!is_inf(f)) fmin = min_of(fmin, add_rn(acc[i], f));
      }
    }
  }
  fmin = warp_min(fmin);
  if ((threadIdx.x & 31) == 0 && !is_inf(fmin)) atomic_min_nonneg(cen + b, fmin);
}

template <typename T, int R>
cudaError_t launch_ring(const T* src, T* dst, const T* cen, T* cen_out, const T* fan,
                        const T* rf, const T* rb, int s, int ml, int ntt, int nt, int n_statics,
                        int n_ring, int nw, bool merge, bool ring, bool copy, cudaStream_t st) {
  const int cols = nw == 1 ? kRingCols : 1;
  const size_t smem = (2 * static_cast<size_t>(nw) * 32 +
                       static_cast<size_t>(ntt) * (cols + 1)) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(ring_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ring_kernel<T, R><<<dim3(ml / cols, s), 32 * (nw == 1 ? kRingCols : nw), smem, st>>>(
      src, dst, cen, cen_out, fan, rf, rb, ml, ntt, nt, n_statics, n_ring, nw, cols, merge, ring,
      copy);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_chain(T* x, const T* cfl, const T* cbl, int rows, int ml, int nw,
                         int n_statics, int rep, int n_chain, bool stage, size_t smem,
                         cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int per_block = nw == 1 ? kChainRows : 1;
  chain_kernel<T, R><<<rows / per_block, 32 * (nw == 1 ? kChainRows : nw), smem, st>>>(
      x, cfl, cbl, ml, nw, n_statics, rep, n_chain, stage);
  return cudaGetLastError();
}

template <typename T>
int run(const T* dist, const T* cen, const T* wrows, const T* ring_f, const T* ring_b,
        const T* cfl, const T* cbl, const T* fan, T* out, T* scratch, T* cen_out, int s, int ml,
        int ntt, int nt, int maxdm, int n_ring_statics, int n_ring, int n_chain_statics,
        int chain_rep, int n_chain, int iters, cudaStream_t st) {
  T* x = out;
  T* y = scratch;
  // ring strips: ntt rows on one warp, 2, 4 or 8 a thread, where that
  // covers them, else 32 a thread on as many warps as it takes (rows past
  // ntt +inf)
  const int ring_r = ntt <= 64 ? 2 : ntt <= 128 ? 4 : ntt <= 256 ? 8 : 32;
  const int ring_nw = (ntt + ring_r * 32 - 1) / (ring_r * 32);
  const int ring_cols = ring_nw == 1 ? kRingCols : 1;
  const size_t ring_smem = (2 * static_cast<size_t>(ring_nw) * 32 +
                            static_cast<size_t>(ntt) * (ring_cols + 1)) * sizeof(T);
  // chain strips: exactly ml lanes, the most lanes a thread (a multiple
  // of 4, at most 32) that divide them on the fewest warps
  int chain_r = 32;
  while (chain_r > 4 && (ml / 32) % chain_r) chain_r -= 4;
  const int chain_nw = ml / (32 * chain_r);
  const int chain_rows = chain_nw == 1 ? kChainRows : 1;
  const size_t chain_xchg = 2 * static_cast<size_t>(chain_nw) * 32 * sizeof(T);
  const size_t chain_costs = 2 * static_cast<size_t>(n_chain_statics + 1) * ml * sizeof(T);
  const bool chain_stage = chain_xchg + chain_costs <= kSmemBudget;
  const size_t chain_smem = chain_xchg + (chain_stage ? chain_costs : 0);
  const size_t band_smem = static_cast<size_t>(kBandRing) * (kBandLanes + 2 * maxdm) * sizeof(T);
  if (ring_nw > 32 || chain_nw > 32 || (ml / 32) % chain_r || ring_smem > kSmemBudget ||
      band_smem > kSmemBudget || (s * ntt) % chain_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wrap = ntt == nt;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(band_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(band_smem))) != cudaSuccess)
    return static_cast<int>(e);
  // band runs of whole steps, enough blocks for kBandBlocksPerSm a SM
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int chunks = ml / kBandLanes;
  const long long want = static_cast<long long>(kBandBlocksPerSm) * sms;
  long long runs = (want + static_cast<long long>(chunks) * s - 1) /
                   (static_cast<long long>(chunks) * s);
  if (runs < 1) runs = 1;
  int band_run = static_cast<int>((ntt + runs - 1) / runs);
  band_run = (band_run + kBandRows - 1) / kBandRows * kBandRows;
  const dim3 band_grid(chunks, (ntt + band_run - 1) / band_run, s);

  auto rows = [&](const T* src, T* dst, bool merge, bool ring, bool copy) {
#define TITER_RING(R)                                                                      \
  launch_ring<T, R>(src, dst, cen, cen_out, fan, ring_f, ring_b, s, ml, ntt, nt,           \
                    n_ring_statics, n_ring, ring_nw, merge, ring, copy, st)
    switch (ring_r) {
      case 2: return TITER_RING(2);
      case 4: return TITER_RING(4);
      case 8: return TITER_RING(8);
      default: return TITER_RING(32);
    }
#undef TITER_RING
  };
  auto chain = [&]() {
#define TITER_CHAIN(R)                                                                        \
  launch_chain<T, R>(x, cfl, cbl, s * ntt, ml, chain_nw, n_chain_statics, chain_rep, n_chain, \
                     chain_stage, chain_smem, st)
    switch (chain_r) {
      case 4: return TITER_CHAIN(4);
      case 8: return TITER_CHAIN(8);
      case 12: return TITER_CHAIN(12);
      case 16: return TITER_CHAIN(16);
      case 20: return TITER_CHAIN(20);
      case 24: return TITER_CHAIN(24);
      case 28: return TITER_CHAIN(28);
      default: return TITER_CHAIN(32);
    }
#undef TITER_CHAIN
  };
  if (iters <= 0) return static_cast<int>(rows(dist, x, false, false, true));
  for (int it = 0; it < iters; ++it) {
    e = it == 0 ? rows(dist, x, false, true, true) : rows(y, x, true, true, false);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((e = chain()) != cudaSuccess) return static_cast<int>(e);
    band_kernel<T><<<band_grid, kBandLanes, band_smem, st>>>(x, wrows, fan, y, cen_out, ntt,
                                                             wrap, ml, maxdm, band_run);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(rows(y, x, true, false, false));
}

}  // namespace

// Runs `iters` iterations on `stream`; returns the first CUDA error as
// an int (0 when every launch was accepted).  dist (s*ntt, ml) and cen
// (s,) are read only; out (s*ntt, ml) and cen_out (s,) receive the
// result; scratch (s*ntt, ml) is work space.  Tables as packed by
// pack_twrapped_stencil: wrows (>= (2*maxdm+1)*5, ml), ring_f/ring_b/fan
// (1, ml), cfl/cbl (n_chain_statics+1, 1, ml) (the spans 1, 2, 4, ...,
// chain_rep <= 32).  All contiguous device memory, float32 (is_double ==
// 0) or float64; ml a multiple of 128, ntt of 8.
extern "C" int titer_launch(const void* dist, const void* cen, const void* wrows,
                            const void* ring_f, const void* ring_b, const void* cfl,
                            const void* cbl, const void* fan, void* out, void* scratch,
                            void* cen_out, int s, int ml, int ntt, int nt, int maxdm,
                            int n_ring_statics, int n_ring, int n_chain_statics, int chain_rep,
                            int n_chain, int iters, int is_double, void* stream) {
  if (s < 1 || s > 65535 || ml < 128 || ml % 128 || ntt < 8 || ntt % 8 || nt < 1 || nt > ntt ||
      maxdm < 0 || maxdm >= ml || chain_rep > 32 || n_ring_statics > 4 ||
      static_cast<long long>(s) * ntt * ml >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run<double>(static_cast<const double*>(dist), static_cast<const double*>(cen),
                       static_cast<const double*>(wrows), static_cast<const double*>(ring_f),
                       static_cast<const double*>(ring_b), static_cast<const double*>(cfl),
                       static_cast<const double*>(cbl), static_cast<const double*>(fan),
                       static_cast<double*>(out), static_cast<double*>(scratch),
                       static_cast<double*>(cen_out), s, ml, ntt, nt, maxdm, n_ring_statics,
                       n_ring, n_chain_statics, chain_rep, n_chain, iters, st);
  return run<float>(static_cast<const float*>(dist), static_cast<const float*>(cen),
                    static_cast<const float*>(wrows), static_cast<const float*>(ring_f),
                    static_cast<const float*>(ring_b), static_cast<const float*>(cfl),
                    static_cast<const float*>(cbl), static_cast<const float*>(fan),
                    static_cast<float*>(out), static_cast<float*>(scratch),
                    static_cast<float*>(cen_out), s, ml, ntt, nt, maxdm, n_ring_statics, n_ring,
                    n_chain_statics, chain_rep, n_chain, iters, st);
}
