// The ring and chain min-plus scans of the 'diag' engine's iteration,
// included by csrc/diag.cu (its ring_scan_launch, chain_scan_launch and
// diag_launch launch them).
//
// Replace the XLA ops of raytracer_tpu/ops/diag_circulant.py _ring_scan
// and _chain_scan (the chain by jax.lax.associative_scan), which the JAX
// package runs around its Pallas sweep.  Python wrappers and plain
// PyTorch twins: raytracer_tpu_torch/ops/diag_circulant.py (ring_scan and
// chain_scan, _ring_scan and _chain_scan; chain_tree_reference replays the
// chain kernel's levels).  The field is (Mp, NTL) float32 or float64: row
// m is slot m, lane c < nt is theta c, lanes [nt, NTL) are padding.
//
// Ring scan (exact circular min-plus relaxation along each theta ring, a
// uniform hop cost a row), the closed form of _ring_scan in its order of
// operations: for each direction with finite hop cost c (+inf: the row is
// left as it is), over j = 0 .. nt-1 in that direction's order,
//   base = b - j*c;  pref, suff = cumulative minima of base forward and
//   backward;  inner = pref + j*c;  wrap = (suff + nt*c) + j*c;
//   out = min(out, min(inner, wrap)),
// every product, difference and sum one __fmul_rn / __fsub_rn / __fadd_rn
// (or the double forms): the written ops, never a contracted multiply-add
// (ROADMAP C.7 says what one changes).  The cumulative minima are exact in
// any grouping.  Lanes >= nt are copied.
//
// Chain scan (linear min-plus scan along the slot rows, both directions):
// _sum_min_scan's recursion, the inclusive scan of (sum, min) pairs under
// combine(a, b) = (sa + sb, min(ma + sb, mb)) by jax.lax.associative_scan's
// order (pair, recurse on the odd half, fix up the even half), so every
// sum rounds as JAX's does.  Level l holds floor(Mp / 2^l) values; value i
// of level l sits at row (i + 1) * 2^l - 1, the recursion's in-place
// layout.  The sum component depends on the row only, so its tree (every
// level's sums, packed once a stencil on the host in the field's dtype by
// the same recursion: diag_circulant.chain_sum_tree) is read, and the
// kernel scans the min component: up the levels, m[p] = min(m[p - 2^l] +
// s_l[2i+1], m[p]) at p = (2i+2) * 2^l - 1; down them, m[q] = min(m[q -
// 2^l] + s_l[2i], m[q]) at q = (2i+1) * 2^l - 1, i >= 1.  The backward
// direction scans the rows in reverse (index arithmetic, no copy) with
// the reversed costs.  out = min(x, forward, backward).
//
// What bounds them on an H100.  At 127x63 (Mp = 1032, NTL = 128) each
// reads and writes the 0.53 MB field once (0.3 us at 3.35 TB/s); the ring
// does ~16 operations a point, the chain ~8 (0.03 us at 67 TFLOP/s f32,
// H100 SXM data sheet, a card at its 700 W power limit): bytes bound
// both.  As torch ops they took 0.69 ms (ring) and 3.35 ms (chain) on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit, host time mostly: ~250
// small launches for the chain.  Here each is one launch; what holds
// them is latency: the ring's warp scans, the chain's ~2 log2(Mp) block
// barriers.
//
// Design.  Ring: a warp a row, lane c in lane c mod 32 of register c /
// 32, a cumulative minimum a warp shuffle scan carried across the row's
// 32-lane chunks, forward then backward; the forward pass keeps its two
// prefix minima (one a direction) in shared memory for the backward pass.
// Chain: a block takes `cols` lane columns (16 bytes of a row where they
// fit), both directions' Mp x cols tiles in shared memory (cp.async in),
// the levels of both directions between the same block barriers.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace diag_scans {

constexpr int kRingWarps = 8;     // rows a ring block, most
constexpr int kChainThreads = 256;

using minplus::add_rn;
using minplus::is_inf;
using minplus::min_of;
using minplus::mul_rn;
using minplus::pos_inf;
using minplus::sub_rn;


template <typename T>
__device__ __forceinline__ T warp_cummin_fwd(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = min_of(v, u);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_cummin_bwd(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v = min_of(v, u);
  }
  return v;
}

// grid ceil(mp / warps): a row a warp.  smem: warps x 2 x ntl values.
template <typename T>
__global__ void ring_scan_kernel(const T* __restrict__ x, const T* __restrict__ rf,
                                 const T* __restrict__ rb, T* __restrict__ out, int mp, int ntl,
                                 int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= mp) return;  // no block barrier below
  T* pf = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * ntl;
  T* pb = pf + ntl;
  const T* xr = x + static_cast<size_t>(m) * ntl;
  T* outr = out + static_cast<size_t>(m) * ntl;
  const T inf = pos_inf<T>();
  const T zero = static_cast<T>(0);
  const bool fin_f = !is_inf(rf[m]), fin_b = !is_inf(rb[m]);
  const T cf = fin_f ? rf[m] : zero, cb = fin_b ? rb[m] : zero;
  const T ntf = mul_rn(static_cast<T>(nt), cf), ntb = mul_rn(static_cast<T>(nt), cb);
  const int chunks = ntl / 32;
  // the bases of lane c: forward j = c, backward j = nt - 1 - c
  auto bases = [&](int c, T b, T& jf, T& jb, T& bf, T& bb) {
    jf = mul_rn(static_cast<T>(c), cf);
    jb = mul_rn(static_cast<T>(nt - 1 - c), cb);
    bf = c < nt ? sub_rn(b, jf) : inf;
    bb = c < nt ? sub_rn(b, jb) : inf;
  };
  // forward over c: the forward direction's prefix minima and the
  // backward direction's suffix minima (its j runs the other way)
  T carry_f = inf, carry_b = inf;
  for (int k = 0; k < chunks; ++k) {
    const int c = 32 * k + lane;
    T jf, jb, bf, bb;
    bases(c, xr[c], jf, jb, bf, bb);
    bf = min_of(warp_cummin_fwd(bf, lane), carry_f);
    bb = min_of(warp_cummin_fwd(bb, lane), carry_b);
    pf[c] = bf;
    pb[c] = bb;
    carry_f = __shfl_sync(0xffffffffu, bf, 31);
    carry_b = __shfl_sync(0xffffffffu, bb, 31);
  }
  carry_f = inf;
  carry_b = inf;
  for (int k = chunks - 1; k >= 0; --k) {
    const int c = 32 * k + lane;
    const T body = xr[c];
    T jf, jb, bf, bb;
    bases(c, body, jf, jb, bf, bb);
    bf = min_of(warp_cummin_bwd(bf, lane), carry_f);
    bb = min_of(warp_cummin_bwd(bb, lane), carry_b);
    carry_f = __shfl_sync(0xffffffffu, bf, 0);
    carry_b = __shfl_sync(0xffffffffu, bb, 0);
    T o = body;
    if (c < nt) {
      // forward: pref = pf, suff = bf; backward (in its own order):
      // pref = bb, suff = pb
      const T res_f = min_of(add_rn(pf[c], jf), add_rn(add_rn(bf, ntf), jf));
      const T res_b = min_of(add_rn(bb, jb), add_rn(add_rn(pb[c], ntb), jb));
      o = min_of(o, fin_f ? res_f : body);
      o = min_of(o, fin_b ? res_b : body);
    }
    outr[c] = o;
  }
}

// One direction's min component through the levels: the up half
// (l < levels, rising) when `up`, else the down half (falling).  a: the
// tile (mp x cols, row-major), tree: every level's sums.
template <typename T>
__device__ __forceinline__ void chain_level(T* a, const T* __restrict__ tree, int off, int l,
                                            int n, int cols, bool up, int i0, int items) {
  const int span = 1 << l;
  for (int it = i0; it < items; it += blockDim.x) {
    const int i = it / cols, j = it - i * cols;
    if (up) {
      const int p = ((2 * i + 2) << l) - 1;
      T* dst = a + static_cast<size_t>(p) * cols + j;
      *dst = min_of(add_rn(dst[-span * cols], tree[off + 2 * i + 1]), *dst);
    } else {
      const int q = ((2 * i + 3) << l) - 1;  // value 2(i+1), i + 1 >= 1
      T* dst = a + static_cast<size_t>(q) * cols + j;
      *dst = min_of(add_rn(dst[-span * cols], tree[off + 2 * i + 2]), *dst);
    }
  }
}

// grid ntl / cols: `cols` lane columns a block, both directions.
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
chain_scan_kernel(const T* __restrict__ x, const T* __restrict__ tree_f,
                  const T* __restrict__ tree_b, T* __restrict__ out, int mp, int ntl, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* af = reinterpret_cast<T*>(smem_raw);
  T* ab = af + static_cast<size_t>(mp) * cols;
  const int c0 = blockIdx.x * cols;
  const int n_all = mp * cols;
  if (cols * sizeof(T) == 16) {  // a row's columns in one 16-byte copy
    for (int r = threadIdx.x; r < mp; r += blockDim.x) {
      const T* src = x + static_cast<size_t>(r) * ntl + c0;
      cp_async16(af + static_cast<size_t>(r) * cols, src);
      cp_async16(ab + static_cast<size_t>(mp - 1 - r) * cols, src);
    }
  } else {
    for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
      const int r = i / cols, j = i - r * cols;
      const T* src = x + static_cast<size_t>(r) * ntl + c0 + j;
      cp_async_ca<sizeof(T)>(af + i, src);
      cp_async_ca<sizeof(T)>(ab + static_cast<size_t>(mp - 1 - r) * cols + j, src);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  int levels = 0, off = 0;
  for (int n = mp; n >= 2; n >>= 1, ++levels) {
    const int items = (n / 2) * cols;  // both directions' pairs
    chain_level(af, tree_f, off, levels, n, cols, true, threadIdx.x, items);
    chain_level(ab, tree_b, off, levels, n, cols, true, threadIdx.x, items);
    __syncthreads();
    off += n;
  }
  for (int l = levels - 1; l >= 0; --l) {
    const int n = mp >> l;
    off -= n;
    const int items = ((n - 1) / 2) * cols;  // values 2, 4, .. <= n - 1
    chain_level(af, tree_f, off, l, n, cols, false, threadIdx.x, items);
    chain_level(ab, tree_b, off, l, n, cols, false, threadIdx.x, items);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    const int r = i / cols, j = i - r * cols;
    const size_t g = static_cast<size_t>(r) * ntl + c0 + j;
    out[g] = min_of(min_of(x[g], af[i]), ab[static_cast<size_t>(mp - 1 - r) * cols + j]);
  }
}

template <typename T>
cudaError_t ring(const T* x, const T* rf, const T* rb, T* out, int mp, int ntl, int nt, int warps,
                 cudaStream_t st) {
  const size_t smem = static_cast<size_t>(warps) * 2 * ntl * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(ring_scan_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ring_scan_kernel<T><<<(mp + warps - 1) / warps, 32 * warps, smem, st>>>(x, rf, rb, out, mp,
                                                                          ntl, nt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t chain(const T* x, const T* tree_f, const T* tree_b, T* out, int mp, int ntl, int cols,
                  cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(mp) * cols * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(chain_scan_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  chain_scan_kernel<T><<<ntl / cols, kChainThreads, smem, st>>>(x, tree_f, tree_b, out, mp, ntl,
                                                               cols);
  return cudaGetLastError();
}

}  // namespace diag_scans
