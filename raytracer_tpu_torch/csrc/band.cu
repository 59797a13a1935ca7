// Band sweep of the theta-major field (the 'stream' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/stream_t.py
// _make_band_kernel / _band_call.  Python wrapper and plain PyTorch twin:
// raytracer_tpu_torch/ops/stream_t.py (band, band_reference).
//
// What it computes.  v is (S, nt, ML) float32, wrows (R8, ML) the
// moving-frame weight rows of pack_twrapped_stencil.  out (S, nt, ML)
// gets, for every (source, theta row c, lane m),
//
//   out[m] = min(v[c][m], min over t in [0, 2*maxdm], u in [0, 5) of
//                v[(c + u - 2) mod nt][x] + wrows[t*5 + u][x]),
//   x = (m - maxdm + t) mod ML,
//
// which is what the TPU kernel computes on its 5 theta-rolled pages
// (page u = v rolled by dc = u - 2 rows), with the roll done in the
// index arithmetic, as csrc/titer.cu's band_kernel does.  Each
// candidate is one __fadd_rn and min does not depend on order, so the
// floats are the TPU kernel's and the plain version's to the bit.
//
// What bounds it on an H100.  At 1080x300 (nt = 1,080, ML = 896,
// maxdm = 8) and S = 1 the function's bytes (the field read once, the
// output written once and the weight rows, 8.1 MB) take 2.4 us at 3.35
// TB/s; the operations, one add and one min per finite tap, are 130 M,
// 1.9 us at 67 TFLOP/s f32.  The first kernel here (one thread a point,
// 170 loads a point from L1/L2, on a 5-page stack of 23.5 MB that its
// caller built with 6 launches) took 0.093 ms, and 0.155 ms with the
// stack, on an NVIDIA H100 80GB HBM3 at a 700 W power limit.  This
// design takes 0.022-0.025 ms there (tools/chip_kernel_ab.py): every
// tap, +inf or not, costs an add, a min and its share of the loads,
// about 220 instructions a point, so the instruction rate and the
// latency of the shared-memory reads hold it at about 9.5 times the
// bound.
//
// Design.  A block of 128 threads takes a chunk of 128 lanes of one
// source and marches a run of theta rows, kRows rows a step.  The rows
// it reads, with maxdm halo lanes on each side (wrapped mod ML), sit in
// a shared-memory ring of kRing rows; cp.async fills the next step's
// rows while the block computes the current one.  A thread keeps the
// kRows accumulators of its lane; for each tap t it reads its 5 weights
// once (through L1: the chunk's 2*maxdm+1 x 5 weight rows are the same
// for every row and source) and the kRows + 4 field rows at lane
// m - maxdm + t once, and each field value serves up to 5 outputs.  So a
// point costs about (kRows + 4) / kRows x (2*maxdm+1) shared-memory
// reads and 5 x (2*maxdm+1) / kRows L1 reads, not 10 x (2*maxdm+1)
// L1/L2 reads.  The run length is chosen by the launch so that the grid
// holds kBlocksPerSm blocks per SM.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kNdc = 5;       // theta offsets dc = -2..2
constexpr int kLanesB = 128;  // output lanes of a block, one a thread
constexpr int kRows = 8;      // theta rows of a step
constexpr int kRing = 32;     // ring rows; >= 2 * kRows + kNdc - 1
constexpr int kBlocksPerSm = 8;
constexpr size_t kSmemBudget = 227 * 1024;

// rows [r0, r0 + n) of the run (run row r is theta row c_begin - 2 + r,
// wrapped) into their ring slots, lanes m0 - maxdm .. m0 + 127 + maxdm
__device__ __forceinline__ void fill_rows(float* ring, const float* vs, int r0, int n,
                                          int c_begin, int nt, int ml, int m0, int maxdm,
                                          int width) {
  for (int r = r0; r < r0 + n; ++r) {
    int c = (c_begin - 2 + r) % nt;
    if (c < 0) c += nt;
    const float* row = vs + static_cast<size_t>(c) * ml;
    float* dst = ring + (r % kRing) * width;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      int x = (m0 - maxdm + j) % ml;
      if (x < 0) x += ml;
      cp_async_ca<4>(dst + j, row + x);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kLanesB) band_kernel(const float* __restrict__ v,
                                                        const float* __restrict__ wrows,
                                                        float* __restrict__ out, int nt, int ml,
                                                        int maxdm, int run) {
  extern __shared__ __align__(16) float ring[];
  const int width = kLanesB + 2 * maxdm;
  const int m0 = blockIdx.x * kLanesB;
  const int c_begin = blockIdx.y * run;
  const int c_end = min(nt, c_begin + run);
  const int s = blockIdx.z;
  const float* vs = v + static_cast<size_t>(s) * nt * ml;
  float* os = out + static_cast<size_t>(s) * nt * ml;
  const int lane = threadIdx.x;
  const int m = m0 + lane;
  const int n_dm = 2 * maxdm + 1;
  int x0 = m - maxdm;  // the weight lane of tap 0, wrapped
  x0 = ((x0 % ml) + ml) % ml;

  const int steps = (c_end - c_begin + kRows - 1) / kRows;
  fill_rows(ring, vs, 0, kRows + kNdc - 1, c_begin, nt, ml, m0, maxdm, width);
  for (int k = 0; k < steps; ++k) {
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in; the last step is done
    if (k + 1 < steps)
      fill_rows(ring, vs, (k + 1) * kRows + kNdc - 1, kRows, c_begin, nt, ml, m0, maxdm,
                width);
    const int rbase = k * kRows;  // run row of theta row c_begin + rbase - 2
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = ring[((rbase + i + 2) % kRing) * width + maxdm + lane];
    int x = x0;
    for (int t = 0; t < n_dm; ++t) {
      float w[kNdc];
#pragma unroll
      for (int u = 0; u < kNdc; ++u) w[u] = __ldg(wrows + static_cast<size_t>(t * kNdc + u) * ml + x);
#pragma unroll
      for (int r = 0; r < kRows + kNdc - 1; ++r) {
        const float f = ring[((rbase + r) % kRing) * width + lane + t];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int u = r - i;  // output row i reads run row rbase + i + u
          if (u >= 0 && u < kNdc) acc[i] = fminf(acc[i], __fadd_rn(f, w[u]));
        }
      }
      x = (x + 1 == ml) ? 0 : x + 1;
    }
    if (m < ml) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int c = c_begin + rbase + i;
        if (c < c_end) os[static_cast<size_t>(c) * ml + m] = acc[i];
      }
    }
  }
}

}  // namespace

// Launches the band sweep on `stream`; returns the CUDA error as an
// int (0 when the launch was accepted).  v and out (s, nt, ml), wrows
// (>= (2*maxdm+1)*5, ml): contiguous float32 device memory of the
// current device.
extern "C" int band_launch(const void* v, const void* wrows, void* out, int s, int nt,
                           int ml, int maxdm, void* stream) {
  if (s < 1 || nt < 1 || ml < 1 || maxdm < 0 || maxdm >= ml || s > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kRing) * (kLanesB + 2 * maxdm) * sizeof(float);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (ml + kLanesB - 1) / kLanesB;
  // runs of whole steps, enough blocks for kBlocksPerSm a SM
  const long long want = static_cast<long long>(kBlocksPerSm) * sms;
  long long runs = (want + static_cast<long long>(chunks) * s - 1) / (static_cast<long long>(chunks) * s);
  if (runs < 1) runs = 1;
  int run = static_cast<int>((nt + runs - 1) / runs);
  run = (run + kRows - 1) / kRows * kRows;
  const int n_runs = (nt + run - 1) / run;
  band_kernel<<<dim3(chunks, n_runs, s), kLanesB, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(wrows), static_cast<float*>(out),
      nt, ml, maxdm, run);
  return static_cast<int>(cudaGetLastError());
}
