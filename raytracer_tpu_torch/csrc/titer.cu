// T Jacobi iterations of the theta-major field (the 'twrapped' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/wrapped_t.py
// _make_titer_kernel / _titer_call.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/wrapped_t.py (titer, titer_reference).
//
// What it computes.  The field is (S*NTT, ML) float32: source block b
// holds NTT theta rows (row t is theta t mod nt; dup = NTT - nt rows
// duplicate the first ones) by ML slot lanes.  Each iteration is
//   1. ring scan along theta: min-plus doubling steps of span 1, 2, 4, 8
//      (those < NTT) then n_ring steps of span 16, forward (row t from
//      row t-s at cost s*ring_f) and then backward (row t from t+s at
//      cost s*ring_b), never across the block's first or last row;
//   2. chain scan along slots: steps of span 1, 2, ... then n_chain
//      steps of the repeat span, forward (lane m from m-s, window cost
//      cfl) and backward (lane m from m+s, cbl), lanes wrapping mod ML
//      onto +inf window costs;
//   3. band sweep (csrc/band.cuh) over the 5 theta-shifted pages: with
//      dup == 0 the shift wraps mod NTT inside the block, with dup > 0
//      rows shifted past the block's edge are +inf; then the duplicate
//      merge: rows t < dup also take the band result of row t+nt and
//      rows t >= nt that of row t-nt;
//   4. the centre fan: cen[b] = min(cen[b], min over the block of
//      field + fan_w), then field = min(field, cen[b] + fan_w).
// Every step reads the values of the step before (Jacobi), as the TPU
// kernel's whole-array rolls do, so the span schedule and every add are
// the TPU kernel's: the results are the same floats.
//
// The TPU kernel holds the whole (S*NTT, ML) page in VMEM; no SM holds
// that (184 x 896 x 4 B = 660 KB per source at 180x63), so each phase
// is its own kernel on the caller's stream, and the launch boundary is
// the sync across the grid between phases:
//   ring : one block per (source, tile of LT lanes), the tile's theta
//          column in shared memory, double-buffered (2*NTT*LT floats;
//          LT = 32 unless the column is too long);
//   chain: one block per (source, theta row), the row in shared memory,
//          double-buffered;
//   band : one thread per output point, reading the scanned field from
//          global memory (L2) and writing a second buffer;
//   fan  : a per-source min by atomicMin on the int bit pattern (exact:
//          every value is >= 0 or +inf), then a broadcast pass that
//          writes the field back into the first buffer.
//
// What bounds it on an H100.  At 180x63 (NTT=184, ML=896, maxdm=48 with
// band closure 1: 485 taps per output) one launch of T=4 iterations does
// about 0.76 G add and min operations, 11 us at 67 TFLOP/s f32 (H100 SXM
// data sheet, for a card at its 700 W power limit), and must move about
// 3 MB (field in and out, tables), 1 us at 3.35 TB/s: operations bound
// it.  The band phase carries ~85 % of the operations.  chip_smoke.py
// recomputes the bound from the inputs of its run (counting band taps
// only where the weight is finite); this kernel took 0.60 ms per launch
// there on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).  One cooperative launch with grid-wide syncs in
// place of the 5*T launches is later work.

#include <cuda_runtime.h>

#include "band.cuh"

namespace {

constexpr int kRingRepeat = 16;
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use

__global__ void ring_kernel(float* x, const float* __restrict__ rf,
                            const float* __restrict__ rb, int ntt, int ml,
                            int lt, int n_statics, int n_ring) {
  extern __shared__ float sm[];
  float* a = sm;
  float* b = sm + static_cast<size_t>(ntt) * lt;
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int m = blockIdx.x * lt + tx;
  float* col = x + static_cast<size_t>(blockIdx.y) * ntt * ml + m;
  for (int t = ty; t < ntt; t += ny) a[t * lt + tx] = col[static_cast<size_t>(t) * ml];
  const float cf = rf[m], cb = rb[m];
  __syncthreads();
  const int n_steps = n_statics + n_ring;
  for (int k = 0; k < n_steps; ++k) {  // forward: row t from row t-s
    const int s = k < n_statics ? (1 << k) : kRingRepeat;
    const float c = __fmul_rn(static_cast<float>(s), cf);
    for (int t = ty; t < ntt; t += ny) {
      float v = a[t * lt + tx];
      if (t >= s) v = fminf(v, __fadd_rn(a[(t - s) * lt + tx], c));
      b[t * lt + tx] = v;
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  for (int k = 0; k < n_steps; ++k) {  // backward: row t from row t+s
    const int s = k < n_statics ? (1 << k) : kRingRepeat;
    const float c = __fmul_rn(static_cast<float>(s), cb);
    for (int t = ty; t < ntt; t += ny) {
      float v = a[t * lt + tx];
      if (t < ntt - s) v = fminf(v, __fadd_rn(a[(t + s) * lt + tx], c));
      b[t * lt + tx] = v;
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  for (int t = ty; t < ntt; t += ny) col[static_cast<size_t>(t) * ml] = a[t * lt + tx];
}

__global__ void chain_kernel(float* x, const float* __restrict__ cfl,
                             const float* __restrict__ cbl, int ml,
                             int n_statics, int rep, int n_chain) {
  extern __shared__ float sm[];
  float* a = sm;
  float* b = sm + ml;
  float* row = x + static_cast<size_t>(blockIdx.x) * ml;
  for (int m = threadIdx.x; m < ml; m += blockDim.x) a[m] = row[m];
  __syncthreads();
  const int n_steps = n_statics + n_chain;
  for (int k = 0; k < n_steps; ++k) {  // forward: lane m from lane m-s
    const int s = k < n_statics ? (1 << k) : rep;
    const float* c = cfl + static_cast<size_t>(k < n_statics ? k : n_statics) * ml;
    for (int m = threadIdx.x; m < ml; m += blockDim.x) {
      const int src = m >= s ? m - s : m - s + ml;
      b[m] = fminf(a[m], __fadd_rn(a[src], c[m]));
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  for (int k = 0; k < n_steps; ++k) {  // backward: lane m from lane m+s
    const int s = k < n_statics ? (1 << k) : rep;
    const float* c = cbl + static_cast<size_t>(k < n_statics ? k : n_statics) * ml;
    for (int m = threadIdx.x; m < ml; m += blockDim.x) {
      const int src = m + s < ml ? m + s : m + s - ml;
      b[m] = fminf(a[m], __fadd_rn(a[src], c[m]));
    }
    __syncthreads();
    float* tmp = a; a = b; b = tmp;
  }
  for (int m = threadIdx.x; m < ml; m += blockDim.x) row[m] = a[m];
}

// Band sweep of theta row t of one source block (blk: NTT rows of ml).
__device__ __forceinline__ float band_row(const float* blk,
                                          const float* __restrict__ wrows,
                                          int t, int ntt, int dup, int ml,
                                          int maxdm, int m) {
  const float* page[band::kNdc];
#pragma unroll
  for (int u = 0; u < band::kNdc; ++u) {
    int tt = t + u - 2;
    if (dup == 0) {
      tt = tt < 0 ? tt + ntt : (tt >= ntt ? tt - ntt : tt);
      page[u] = blk + static_cast<size_t>(tt) * ml;
    } else {
      page[u] = (tt >= 0 && tt < ntt) ? blk + static_cast<size_t>(tt) * ml
                                      : nullptr;
    }
  }
  return band::band_point(page, wrows, ml, maxdm, m,
                          blk[static_cast<size_t>(t) * ml + m]);
}

__global__ void band_merge_kernel(const float* __restrict__ x,
                                  const float* __restrict__ wrows,
                                  float* __restrict__ y, size_t n, int ntt,
                                  int nt, int ml, int maxdm) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = static_cast<int>(i % ml);
  const size_t r = i / ml;
  const int t = static_cast<int>(r % ntt);
  const float* blk = x + (r - t) * ml;
  const int dup = ntt - nt;
  float acc = band_row(blk, wrows, t, ntt, dup, ml, maxdm, m);
  if (t < dup) acc = fminf(acc, band_row(blk, wrows, t + nt, ntt, dup, ml, maxdm, m));
  if (t >= nt) acc = fminf(acc, band_row(blk, wrows, t - nt, ntt, dup, ml, maxdm, m));
  y[i] = acc;
}

// grid (blocks per source, S): cen[b] = min(cen[b], min(y + fan)).
__global__ void fan_reduce_kernel(const float* __restrict__ y,
                                  const float* __restrict__ fan, float* cen,
                                  int per_source, int ml) {
  const float* blk = y + static_cast<size_t>(blockIdx.y) * per_source;
  float v = __int_as_float(0x7f800000);  // +inf
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_source;
       i += gridDim.x * blockDim.x) {
    v = fminf(v, __fadd_rn(blk[i], fan[i % ml]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  __shared__ float warp_min[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_min[lane] : __int_as_float(0x7f800000);
    for (int off = 16; off > 0; off >>= 1) {
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    // non-negative floats and +inf order as their int bit patterns
    if (lane == 0) atomicMin(reinterpret_cast<int*>(cen + blockIdx.y), __float_as_int(v));
  }
}

__global__ void fan_bcast_kernel(const float* __restrict__ y,
                                 const float* __restrict__ fan,
                                 const float* __restrict__ cen,
                                 float* __restrict__ x, size_t n,
                                 int per_source, int ml) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = static_cast<int>(i % ml);
  x[i] = fminf(y[i], __fadd_rn(cen[i / per_source], fan[m]));
}

}  // namespace

// Runs `iters` iterations on `stream`; returns the first CUDA error as
// an int (0 when every launch was accepted).  dist (s*ntt, ml) and cen
// (s,) are read only; out (s*ntt, ml) and cen_out (s,) receive the
// result; scratch (s*ntt, ml) is work space.  Tables as packed by
// pack_twrapped_stencil: wrows (R8, ml), ring_f/ring_b/fan (1, ml),
// cfl/cbl (n_chain_statics+1, 1, ml).  All contiguous float32 device
// memory.
extern "C" int titer_launch(const void* dist, const void* cen,
                            const void* wrows, const void* ring_f,
                            const void* ring_b, const void* cfl,
                            const void* cbl, const void* fan, void* out,
                            void* scratch, void* cen_out, int s, int ml,
                            int ntt, int nt, int maxdm, int n_ring_statics,
                            int n_ring, int n_chain_statics, int chain_rep,
                            int n_chain, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(s) * ntt * ml;
  const int per_source = ntt * ml;
  float* x = static_cast<float*>(out);
  float* y = static_cast<float*>(scratch);
  float* c = static_cast<float*>(cen_out);
  const float* w = static_cast<const float*>(wrows);
  const float* fw = static_cast<const float*>(fan);

  cudaError_t e = cudaMemcpyAsync(x, dist, n * sizeof(float),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyAsync(c, cen, s * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  int lt = 32;
  while (lt > 1 && 2 * static_cast<size_t>(ntt) * lt * sizeof(float) > kSmemBudget) lt /= 2;
  const size_t ring_smem = 2 * static_cast<size_t>(ntt) * lt * sizeof(float);
  const size_t chain_smem = 2 * static_cast<size_t>(ml) * sizeof(float);
  if (ring_smem > kSmemBudget || chain_smem > kSmemBudget || ml % lt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(ring_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(chain_smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 ring_grid(ml / lt, s), ring_block(lt, 1024 / lt);
  const int chain_threads = ml < 1024 ? ml : 1024;
  const int threads = 256;
  const unsigned pt_blocks = static_cast<unsigned>((n + threads - 1) / threads);
  int red_blocks = (per_source + threads * 8 - 1) / (threads * 8);
  if (red_blocks > 1024) red_blocks = 1024;
  const dim3 red_grid(red_blocks, s);

  for (int it = 0; it < iters; ++it) {
    ring_kernel<<<ring_grid, ring_block, ring_smem, st>>>(
        x, static_cast<const float*>(ring_f), static_cast<const float*>(ring_b),
        ntt, ml, lt, n_ring_statics, n_ring);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    chain_kernel<<<s * ntt, chain_threads, chain_smem, st>>>(
        x, static_cast<const float*>(cfl), static_cast<const float*>(cbl), ml,
        n_chain_statics, chain_rep, n_chain);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    band_merge_kernel<<<pt_blocks, threads, 0, st>>>(x, w, y, n, ntt, nt, ml, maxdm);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    fan_reduce_kernel<<<red_grid, threads, 0, st>>>(y, fw, c, per_source, ml);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    fan_bcast_kernel<<<pt_blocks, threads, 0, st>>>(y, fw, c, x, n, per_source, ml);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
