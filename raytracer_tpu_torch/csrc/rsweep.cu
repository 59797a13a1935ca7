// Radial Gauss-Seidel sweep of the T-layout travel-time field.
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/sweep_theta.py
// _make_rsweep_kernel / _rsweep_call.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/sweep_theta.py (rsweep, rsweep_reference).
//
// What it computes.  buf is (S, MT+K8, NTL) float32, rows = radial slots,
// lanes = theta columns.  The down sweep holds the field in rows [0, MT)
// with K8 +inf pad rows above it and visits rows MT-1 .. 0 (taps dm > 0);
// the up sweep holds the field in rows [K8, K8+MT) with the pad below and
// visits rows K8 .. K8+MT-1 (taps dm < 0).  For each visited row r and
// lane c:
//     buf[r, c] = min(buf[r, c],
//                     min over taps (buf[r+dm, lane(c, dc)] + wtab[r, iw]))
// where lane(c, dc) = (c+dc) mod NTL when the lane axis is one block
// (NTB == NTL), and when it is split into NTB-wide blocks, c+dc inside
// c's block or else no candidate (+inf): blocks are seam-blind at both
// edges and the solver's seamfix re-applies those edges exactly.  Every
// source row r+dm is final when row r is visited, so visiting rows one
// by one gives the same floats as the TPU kernel's 8-row macro-blocks:
// each candidate is one f32 add and min does not depend on order.
//
// What bounds it on an H100.  The bytes are tiny (the 180x63 field is
// 0.9 MB, wtab 0.9 MB: both stay in L2) and so are the operations (2
// per tap, 86 M at 180x63).  The limit is the chain of MT (840) rows,
// each of which depends on the rows before it: one block barrier and one
// dependent L1/L2 round trip per row, a few microseconds per row at
// best.  Lanes are independent within a row, so one CTA per source walks
// the rows with its threads striding over the lanes, and a __syncthreads
// after each row makes that row visible before the next one reads it.
// The tap table lives in shared memory; weights and field are read from
// global memory (L1/L2 resident).  Making the chain shorter (several
// rows per barrier where taps allow, rows held in shared memory) is
// later work.

#include <cuda_runtime.h>

namespace {

__global__ void rsweep_kernel(float* buf,
                              const float* __restrict__ wtab,
                              const int* __restrict__ taps, int n_taps,
                              int rows_total, int ntl, int ntb, int d,
                              int r_first, int r_step, int n_rows) {
  extern __shared__ int s_taps[];  // (n_taps, 3): dm, dc, iw
  for (int i = threadIdx.x; i < 3 * n_taps; i += blockDim.x) {
    s_taps[i] = taps[i];
  }
  __syncthreads();

  float* field = buf + static_cast<size_t>(blockIdx.x) * rows_total * ntl;
  const bool blocked = ntb < ntl;

  for (int k = 0; k < n_rows; ++k) {
    const int r = r_first + k * r_step;
    const float* wrow = wtab + static_cast<size_t>(r) * d;
    float* dst = field + static_cast<size_t>(r) * ntl;
    for (int c = threadIdx.x; c < ntl; c += blockDim.x) {
      const int blk0 = (c / ntb) * ntb;
      const int loc = c - blk0;
      float cur = dst[c];
      for (int t = 0; t < n_taps; ++t) {
        const int dm = s_taps[3 * t];
        const int dc = s_taps[3 * t + 1];
        const int iw = s_taps[3 * t + 2];
        int sl = loc + dc;
        if (sl < 0 || sl >= ntb) {
          if (blocked) continue;  // crossed a block edge: +inf candidate
          sl = sl < 0 ? sl + ntb : sl - ntb;  // |dc| <= 2 < ntb
        }
        const float src = field[static_cast<size_t>(r + dm) * ntl + blk0 + sl];
        cur = fminf(cur, src + wrow[iw]);
      }
      dst[c] = cur;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the sweep on `stream`; returns cudaGetLastError() as an int.
// buf (S, mt+k8, ntl) float32, wtab (mt+k8, d) float32, taps (n_taps, 3)
// int32, all contiguous device memory.  upward = 0 for the down sweep.
extern "C" int rsweep_launch(void* buf, const void* wtab, const void* taps,
                             int n_taps, int s, int mt, int k8, int ntl,
                             int ntb, int d, int upward, void* stream) {
  const int rows_total = mt + k8;
  const int r_first = upward ? k8 : mt - 1;
  const int r_step = upward ? 1 : -1;
  const int threads = ntl < 1024 ? ntl : 1024;
  const size_t smem = static_cast<size_t>(3 * n_taps) * sizeof(int);
  rsweep_kernel<<<s, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), static_cast<const float*>(wtab),
      static_cast<const int*>(taps), n_taps, rows_total, ntl, ntb, d,
      r_first, r_step, mt);
  return static_cast<int>(cudaGetLastError());
}
