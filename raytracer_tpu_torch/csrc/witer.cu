// T full Jacobi iterations of the slot-major field (the 'wrapped' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/diag_wrapped.py
// _make_iter_kernel / _iter_call.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/diag_wrapped.py (witer, witer_reference).
//
// What it computes.  The field is (Mp, S*NTL) float32: row m is slot m,
// source block b holds NTL theta lanes (lane l is theta l mod nt; the
// dup = NTL - nt lanes [nt, NTL) duplicate thetas 0..dup-1).  It is the
// transposed form of csrc/titer.cu.  Each iteration is
//   1. ring scan along theta (lanes): min-plus steps of span 1, 2, 4, 8,
//      then n_ring steps of span 16, forward (lane l from lane l-s at
//      cost s*ring_f[m]) and then backward (lane l from l+s at cost
//      s*ring_b[m]), never across the block's first or last lane;
//   2. chain scan along slots (rows): steps of span 1, 2, ... then
//      n_chain steps of the repeat span, forward (row m from m-s, window
//      cost cfl) and backward (row m from m+s, cbl), rows wrapping mod Mp
//      onto +inf window costs;
//   3. band sweep over the Dp (dm, dc) diagonals: out[m, l] =
//      min(cur[m, l], cur[m+dm, l+dc] + w_j[m]), reading +inf for rows
//      outside [0, Mp) and, when dup > 0, for in-block lanes l+dc outside
//      [0, NTL) (the defect lanes); with dup == 0 the lane wraps mod NTL
//      inside the block.  Then the duplicate merge: lanes l < dup also
//      take the band result of lane l+nt, lanes l >= nt that of l-nt;
//   4. the centre fan: cen[b] = min(cen[b], min over the block of
//      field + fan_w), then field = min(field, cen[b] + fan_w).
// Every step reads the values of the step before (Jacobi), as the TPU
// kernel's whole-array rolls do, so the span schedule and every add are
// the TPU kernel's: the results are the same floats.  Min does not
// depend on order, so the band may visit the diagonals in any order and
// skip those whose weight is +inf for the row (the TPU's no-op padding
// diagonals among them).
//
// The TPU kernel holds the whole field and a 5-page shifted copy in VMEM
// (824 x 256 x 4 B = 843 KB per source at 183x63, 4.5 MB with the
// pages); no SM holds that, so each phase is its own kernel on the
// caller's stream, and the launch boundary is the sync across the grid:
//   ring : one block per (source, tile of kRingRows rows), the rows'
//          NTL lanes double-buffered in shared memory;
//   chain: one block per tile of LT lanes, the tile's Mp-row columns
//          double-buffered in shared memory (LT = 8, halved while the
//          columns would not fit the 227 KB a block may use: 53 KB at
//          Mp = 824);
//   band : one block per (row, 128 lanes), one thread per output point,
//          threads along lanes, so a diagonal's weight (it depends on
//          the row only) is one shared-memory broadcast; the block loads
//          the diagonals' (dm, dc) and the row's weights into shared
//          memory and reads the field from global memory (L1/L2); the
//          merge is fused in by evaluating the twin lane's band too (the
//          moving-frame point of csrc/band.cuh reads theta-major weight
//          rows, a layout this field does not have, so the point is
//          written here);
//   fan  : a per-source min by atomicMin on the int bit pattern (exact:
//          every value is >= 0 or +inf), then a broadcast pass that
//          writes the field back into the first buffer.
//
// What bounds it on an H100.  At 183x63 (Mp = 824, NTL = 256, dup = 73,
// Dp = 404 grouped diagonals) one launch of T = 4 iterations does about
// 0.3-0.4 G add and min operations (band taps only where the weight is
// finite, the dup lanes' merged taps, the scans and the fan), ~5 us at
// 67 TFLOP/s f32 (H100 SXM data sheet, for a card at its 700 W power
// limit), and must move about 2.6 MB (field in and out, the tables),
// ~1 us at 3.35 TB/s: operations bound it.  chip_smoke.py recomputes the
// bound from the inputs of its run.  The band phase carries most of the
// operations; its per-point loop over the diagonals, the recomputed
// band of the duplicate lanes and the 5*T launches are what this simple
// first form pays beyond the bound (PERF.md keeps its card time).

#include <cuda_runtime.h>

namespace {

constexpr int kRingRepeat = 16;
constexpr int kRingStatics = 4;   // spans 1, 2, 4, 8
constexpr int kRingRows = 4;      // rows per ring block
constexpr int kBandLanes = 128;   // threads per band block
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 227 * 1024;  // what a block may use

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// grid (ceil(mp / kRingRows), s): the ring scan of kRingRows rows of one
// source block, in place.
__global__ void ring_kernel(float* x, const float* __restrict__ rf,
                            const float* __restrict__ rb, int mp, int ntl,
                            int ntlt, int n_ring) {
  extern __shared__ float sm[];
  float* a = sm;
  float* b = sm + kRingRows * ntl;
  const int m0 = blockIdx.x * kRingRows;
  const int rows = min(kRingRows, mp - m0);
  const int n = rows * ntl;
  float* base = x + static_cast<size_t>(m0) * ntlt
                + static_cast<size_t>(blockIdx.y) * ntl;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ntl, l = i - r * ntl;
    a[i] = base[static_cast<size_t>(r) * ntlt + l];
  }
  __syncthreads();
  const int n_steps = kRingStatics + n_ring;
  for (int dir = 0; dir < 2; ++dir) {
    const float* cost = dir == 0 ? rf : rb;
    for (int k = 0; k < n_steps; ++k) {
      const int s = k < kRingStatics ? (1 << k) : kRingRepeat;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / ntl, l = i - r * ntl;
        const float c = __fmul_rn(static_cast<float>(s), cost[m0 + r]);
        float v = a[i];
        if (dir == 0) {
          if (l >= s) v = fminf(v, __fadd_rn(a[i - s], c));  // from l-s
        } else {
          if (l < ntl - s) v = fminf(v, __fadd_rn(a[i + s], c));  // from l+s
        }
        b[i] = v;
      }
      __syncthreads();
      float* t = a; a = b; b = t;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ntl, l = i - r * ntl;
    base[static_cast<size_t>(r) * ntlt + l] = a[i];
  }
}

// grid (ntlt / lt): the chain scan of lt lane columns, in place.
__global__ void chain_kernel(float* x, const float* __restrict__ cfl,
                             const float* __restrict__ cbl, int mp, int ntlt,
                             int lt, int n_statics, int rep, int n_chain) {
  extern __shared__ float sm[];
  float* a = sm;
  float* b = sm + static_cast<size_t>(mp) * lt;
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  float* col = x + static_cast<size_t>(blockIdx.x) * lt + tx;
  for (int m = ty; m < mp; m += ny) a[m * lt + tx] = col[static_cast<size_t>(m) * ntlt];
  __syncthreads();
  const int n_steps = n_statics + n_chain;
  for (int dir = 0; dir < 2; ++dir) {
    const float* cost = dir == 0 ? cfl : cbl;
    for (int k = 0; k < n_steps; ++k) {
      const int s = k < n_statics ? (1 << k) : rep;  // every span < mp
      const float* c = cost + static_cast<size_t>(k < n_statics ? k : n_statics) * mp;
      for (int m = ty; m < mp; m += ny) {
        int src = dir == 0 ? m - s : m + s;
        src = src < 0 ? src + mp : (src >= mp ? src - mp : src);
        b[m * lt + tx] = fminf(a[m * lt + tx], __fadd_rn(a[src * lt + tx], c[m]));
      }
      __syncthreads();
      float* t = a; a = b; b = t;
    }
  }
  for (int m = ty; m < mp; m += ny) col[static_cast<size_t>(m) * ntlt] = a[m * lt + tx];
}

// Band sweep of in-block lane lb of row m (blk: the source block's first
// lane, rows ntlt apart).
__device__ __forceinline__ float band_at(const float* blk, const int2* tap,
                                         const float* w, int dp, int m,
                                         int lb, int mp, int ntl, int ntlt,
                                         bool wrap) {
  float acc = blk[static_cast<size_t>(m) * ntlt + lb];
  for (int j = 0; j < dp; ++j) {
    const float wj = w[j];
    if (isinf(wj)) continue;  // the same for every thread of the block
    const int2 t = tap[j];
    const int mm = m + t.x;
    if (mm < 0 || mm >= mp) continue;
    int ll = lb + t.y;
    if (ll < 0 || ll >= ntl) {
      if (!wrap) continue;  // defect lane: +inf
      ll = ll < 0 ? ll + ntl : ll - ntl;
    }
    acc = fminf(acc, __fadd_rn(blk[static_cast<size_t>(mm) * ntlt + ll], wj));
  }
  return acc;
}

// grid (ceil(ntlt / kBandLanes), mp): band sweep + duplicate merge, x -> y.
__global__ void band_merge_kernel(const float* __restrict__ x,
                                  const int* __restrict__ taps,
                                  const float* __restrict__ wpT,
                                  float* __restrict__ y, int mp, int ntl,
                                  int ntlt, int nt, int dp, int wstride) {
  extern __shared__ float sm[];
  int2* s_tap = reinterpret_cast<int2*>(sm);
  float* s_w = reinterpret_cast<float*>(s_tap + dp);
  const int m = blockIdx.y;
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    s_tap[j] = make_int2(taps[2 * j], taps[2 * j + 1]);
    s_w[j] = wpT[static_cast<size_t>(j) * wstride + m];
  }
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= ntlt) return;
  const int b = l / ntl, lb = l - b * ntl;
  const int dup = ntl - nt;
  const float* blk = x + static_cast<size_t>(b) * ntl;
  const bool wrap = dup == 0;
  float acc = band_at(blk, s_tap, s_w, dp, m, lb, mp, ntl, ntlt, wrap);
  if (lb < dup) acc = fminf(acc, band_at(blk, s_tap, s_w, dp, m, lb + nt, mp, ntl, ntlt, wrap));
  if (lb >= nt) acc = fminf(acc, band_at(blk, s_tap, s_w, dp, m, lb - nt, mp, ntl, ntlt, wrap));
  y[static_cast<size_t>(m) * ntlt + l] = acc;
}

// grid (blocks per source, s): cen[b] = min(cen[b], min(y + fan)) over
// source block b.
__global__ void fan_reduce_kernel(const float* __restrict__ y,
                                  const float* __restrict__ fan, float* cen,
                                  int mp, int ntl, int ntlt) {
  const int b = blockIdx.y;
  const int per_source = mp * ntl;
  float v = inf_f();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_source;
       i += gridDim.x * blockDim.x) {
    const int m = i / ntl, lb = i - m * ntl;
    v = fminf(v, __fadd_rn(y[static_cast<size_t>(m) * ntlt + b * ntl + lb], fan[m]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  __shared__ float warp_min[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_min[lane] : inf_f();
    for (int off = 16; off > 0; off >>= 1) {
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    // non-negative floats and +inf order as their int bit patterns
    if (lane == 0) atomicMin(reinterpret_cast<int*>(cen + b), __float_as_int(v));
  }
}

__global__ void fan_bcast_kernel(const float* __restrict__ y,
                                 const float* __restrict__ fan,
                                 const float* __restrict__ cen,
                                 float* __restrict__ x, size_t n, int ntl,
                                 int ntlt) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = static_cast<int>(i / ntlt);
  const int b = static_cast<int>(i % ntlt) / ntl;
  x[i] = fminf(y[i], __fadd_rn(cen[b], fan[m]));
}

}  // namespace

// Runs `iters` iterations on `stream`; returns the first CUDA error as
// an int (0 when every launch was accepted).  dist (mp, s*ntl) and cen
// (s,) are read only; out (mp, s*ntl) and cen_out (s,) receive the
// result; scratch (mp, s*ntl) is work space.  taps (dp, 2) int32 holds
// each diagonal's (dm, dc) and wpT (>= dp rows of wstride floats) its
// weights by slot; ring_f/ring_b/fan (mp, 1), cfl/cbl
// (n_chain_statics+1, mp, 1).  All contiguous device memory, float32
// apart from taps.
extern "C" int witer_launch(const void* dist, const void* cen,
                            const void* taps, const void* wpT,
                            const void* ring_f, const void* ring_b,
                            const void* cfl, const void* cbl,
                            const void* fan, void* out, void* scratch,
                            void* cen_out, int s, int mp, int ntl, int nt,
                            int dp, int wstride, int n_ring,
                            int n_chain_statics, int chain_rep, int n_chain,
                            int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntlt = s * ntl;
  const size_t n = static_cast<size_t>(mp) * ntlt;
  float* x = static_cast<float*>(out);
  float* y = static_cast<float*>(scratch);
  float* c = static_cast<float*>(cen_out);
  const float* fw = static_cast<const float*>(fan);

  cudaError_t e = cudaMemcpyAsync(x, dist, n * sizeof(float),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyAsync(c, cen, s * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  int lt = 8;
  while (lt > 1 && 2 * static_cast<size_t>(mp) * lt * sizeof(float) > kSmemBudget) lt /= 2;
  const size_t ring_smem = 2 * static_cast<size_t>(kRingRows) * ntl * sizeof(float);
  const size_t chain_smem = 2 * static_cast<size_t>(mp) * lt * sizeof(float);
  const size_t band_smem = static_cast<size_t>(dp) * (sizeof(int2) + sizeof(float));
  if (ring_smem > kSmemBudget || chain_smem > kSmemBudget ||
      band_smem > kSmemBudget || ntlt % lt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(ring_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(chain_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(band_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(band_smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 ring_grid((mp + kRingRows - 1) / kRingRows, s);
  const int chain_ny = 1024 / lt < mp ? 1024 / lt : mp;
  const dim3 chain_block(lt, chain_ny);
  const dim3 band_grid((ntlt + kBandLanes - 1) / kBandLanes, mp);
  const unsigned pt_blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int per_source = mp * ntl;
  int red_blocks = (per_source + kThreads * 8 - 1) / (kThreads * 8);
  if (red_blocks > 1024) red_blocks = 1024;
  const dim3 red_grid(red_blocks, s);

  for (int it = 0; it < iters; ++it) {
    ring_kernel<<<ring_grid, kThreads, ring_smem, st>>>(
        x, static_cast<const float*>(ring_f), static_cast<const float*>(ring_b),
        mp, ntl, ntlt, n_ring);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    chain_kernel<<<ntlt / lt, chain_block, chain_smem, st>>>(
        x, static_cast<const float*>(cfl), static_cast<const float*>(cbl), mp,
        ntlt, lt, n_chain_statics, chain_rep, n_chain);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    band_merge_kernel<<<band_grid, kBandLanes, band_smem, st>>>(
        x, static_cast<const int*>(taps), static_cast<const float*>(wpT), y,
        mp, ntl, ntlt, nt, dp, wstride);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    fan_reduce_kernel<<<red_grid, kThreads, 0, st>>>(y, fw, c, mp, ntl, ntlt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    fan_bcast_kernel<<<pt_blocks, kThreads, 0, st>>>(y, fw, c, x, n, ntl, ntlt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
