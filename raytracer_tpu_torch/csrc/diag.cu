// One relaxation sweep of the diagonal-band stencil (the 'diag' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/diag_circulant.py
// _make_diag_kernel / _sweep_diag.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/diag_circulant.py (diag_sweep,
// diag_sweep_reference).
//
// What it computes.  The field is (Mp, NTL) float32: row m is slot m,
// lane c < nt is theta c, lanes [nt, NTL) are +inf padding.  For each of
// the D (dm, dc) diagonals of the stencil, with weight w_d[m] (+inf where
// slot m has no such edge),
//   out[m, c] = min(dist[m, c], min over d of
//                   dist[m + dm_d, (c + dc_d) mod nt] + w_d[m])
// for c < nt, rows m + dm_d outside [0, Mp) reading +inf, and out = +inf
// on lanes c >= nt.  Each candidate is one f32 add and min does not
// depend on order, so this gives the TPU kernel's floats; diagonals whose
// weight is +inf for the row are skipped (their candidates are +inf).
//
// The TPU kernel read every diagonal as an 8-aligned slice of a 40-copy
// source stack (5 theta rolls x 8 row sub-shifts) that XLA rebuilt before
// each sweep, only to keep its sublane slices aligned: 40 x 1136 x 128 x
// 4 B = 23 MB per sweep at 127x63.  Here each thread reads the field
// itself, one thread per output point, one block per (row, 128 lanes),
// threads along lanes: a diagonal's weight depends on the row only, so
// the block loads the D (dm, dc) pairs and its row's D weights (a (D, Mp)
// row-major table) into shared memory, every weight read is a broadcast
// and the +inf test is the same for the whole block (no divergence).
//
// What bounds it on an H100.  At 127x63 (Mp = 1032, NTL = 128, nt = 127,
// D = 534) one sweep does, over the finite (row, diagonal) weights,
// about 2 x 127 x 5e4 = 1.3e7 add and min operations, 0.2 us at 67
// TFLOP/s f32 (H100 SXM data sheet, for a card at its 700 W power
// limit), and must move the field in and out and the tables once, about
// 3.3 MB, 1 us at 3.35 TB/s: bytes bound it.  chip_smoke.py recomputes
// the bound from its run's inputs.  The diagonal loop re-reads the field
// through L1/L2 some 50 times per point; a shared-memory tile of the
// rows a block needs is the lever beyond this simple first form.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // threads per block
constexpr size_t kSmemBudget = 227 * 1024;

__global__ void diag_kernel(const float* __restrict__ dist,
                            const int* __restrict__ taps,
                            const float* __restrict__ wT,
                            float* __restrict__ out, int d, int mp, int ntl,
                            int nt) {
  extern __shared__ float sm[];
  int2* s_tap = reinterpret_cast<int2*>(sm);
  float* s_w = reinterpret_cast<float*>(s_tap + d);
  const int m = blockIdx.y;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    s_tap[j] = make_int2(taps[2 * j], taps[2 * j + 1]);
    s_w[j] = wT[static_cast<size_t>(j) * mp + m];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ntl) return;
  float acc = __int_as_float(0x7f800000);  // +inf on the padding lanes
  if (c < nt) {
    acc = dist[static_cast<size_t>(m) * ntl + c];
    for (int j = 0; j < d; ++j) {
      const float w = s_w[j];
      if (isinf(w)) continue;  // the same for every thread of the block
      const int2 t = s_tap[j];
      const int mm = m + t.x;
      if (mm < 0 || mm >= mp) continue;
      int cc = c + t.y;  // |dc| <= 2 < nt: one wrap at most
      cc = cc < 0 ? cc + nt : (cc >= nt ? cc - nt : cc);
      acc = fminf(acc, __fadd_rn(dist[static_cast<size_t>(mm) * ntl + cc], w));
    }
  }
  out[static_cast<size_t>(m) * ntl + c] = acc;
}

}  // namespace

// One sweep on `stream`; returns the CUDA error of the launch as an int
// (0 when accepted).  dist (mp, ntl) is read only, out (mp, ntl)
// receives the result; taps (d, 2) int32 holds each diagonal's (dm, dc),
// wT (d, mp) float32 its weights by slot.  All contiguous device memory.
extern "C" int diag_launch(const void* dist, const void* taps,
                           const void* wT, void* out, int d, int mp, int ntl,
                           int nt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(d) * (sizeof(int2) + sizeof(float));
  if (smem > kSmemBudget || nt > ntl) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((ntl + kLanes - 1) / kLanes, mp);
  diag_kernel<<<grid, kLanes, smem, st>>>(
      static_cast<const float*>(dist), static_cast<const int*>(taps),
      static_cast<const float*>(wT), static_cast<float*>(out), d, mp, ntl, nt);
  return static_cast<int>(cudaGetLastError());
}
