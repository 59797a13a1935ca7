// Band sweep of pre-rolled theta-major pages (the 'stream' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/stream_t.py
// _make_band_kernel / _band_call.  Python wrapper and plain PyTorch twin:
// raytracer_tpu_torch/ops/stream_t.py (band, band_reference).
//
// What it computes.  stack is (5, S, nt, ML) float32: page u is the
// field (S, nt, ML) rolled by dc = u-2 theta rows (exact wrap, done by
// the caller); page 2 is the field itself.  wrows is (R8, ML): the
// moving-frame weight rows of pack_twrapped_stencil.  out (S, nt, ML)
// gets, for every (source, theta row, lane), band::band_point of
// csrc/band.cuh.  The TPU kernel also sweeps the +inf rows that pad nt
// to its theta block; the caller drops them, so this kernel is given
// only the nt real rows.
//
// What bounds it on an H100.  One thread per output point loops over
// the (2*maxdm+1)*5 taps; neighbouring threads read neighbouring lanes
// of the same page row and weight row, so every load is coalesced and
// the pages and weight rows are read from L2/L1 again by the threads of
// the 2*maxdm+1 lanes around them.  At 1080x300 (nt=1080, ML=896,
// maxdm=8, 85 taps) and S=1 the bytes that must move are the stack,
// the output and the weight rows, about 23.5 MB, 7 us at 3.35 TB/s
// (H100 SXM data sheet, for a card at its 700 W power limit); the
// operations, one add and one min per tap, are 165 M, 2.5 us at
// 67 TFLOP/s f32: bytes bound it.  chip_smoke.py recomputes the bound
// from the inputs of its run.  This simple kernel took 0.093 ms per
// launch there on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
// 13 times the bound (PERF.md).

#include <cuda_runtime.h>

#include "band.cuh"

namespace {

__global__ void band_kernel(const float* __restrict__ stack,
                            const float* __restrict__ wrows,
                            float* __restrict__ out, size_t n, int ml,
                            int maxdm) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = static_cast<int>(i % ml);
  const size_t row = i - m;  // start of this (source, theta row)
  const float* page[band::kNdc];
#pragma unroll
  for (int u = 0; u < band::kNdc; ++u) page[u] = stack + u * n + row;
  out[i] = band::band_point(page, wrows, ml, maxdm, m, page[2][m]);
}

}  // namespace

// Launches the band sweep on `stream`; returns cudaGetLastError() as an
// int.  stack (5, s, nt, ml), wrows (>= (2*maxdm+1)*5, ml) and out
// (s, nt, ml): contiguous float32 device memory.
extern "C" int band_launch(const void* stack, const void* wrows, void* out,
                           int s, int nt, int ml, int maxdm, void* stream) {
  const size_t n = static_cast<size_t>(s) * nt * ml;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  band_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), static_cast<const float*>(wrows),
      static_cast<float*>(out), n, ml, maxdm);
  return static_cast<int>(cudaGetLastError());
}
