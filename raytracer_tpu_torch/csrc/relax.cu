// One lane-gather relaxation sweep of the circulant stencil (the
// 'pallas' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/contrib/pallas_circulant.py
// _make_relax_kernel / _relax_pallas.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/contrib/pallas_circulant.py (relax,
// relax_reference; relax_items_reference replays this file's work
// partition).
//
// What it computes: see csrc/lane_gather.cuh.  dist is (T, S*ntp, 128),
// out receives one sweep of it, pad rows at +inf.
//
// What bounds it on an H100.  At 180x63 (T = 7, nt = 180, ntp = 184) a
// sweep looks at 64 M candidates per source, of which 24.6 M have a
// finite weight: one add and one min each (49 M operations, 0.7 us at
// 67 TFLOP/s f32, H100 SXM data sheet, for a card at its 700 W power
// limit), and must move the state in and out and the tables once (about
// 4 MB at S = 1, 1.3 us at 3.35 TB/s).  chip_smoke.py computes the bound
// from its run's inputs.  The first form of this file (a thread took 4
// rows of one tile and walked all 220-579 stencil rows of the tile as a
// chain of dependent L2 loads, a branch on each +inf weight) took
// 0.229-0.234 ms at S = 1 on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: latency, not the work.
//
// Design.  Two launches on the caller's stream: an elementwise init (out
// = the input's real rows, +inf on the pad rows), then the relaxation by
// chunk items of csrc/lane_gather.cuh, which csrc/fused.cu runs as its
// phase C: the stencil rows come as the chunk tables of
// fused_circulant.relax_chunks (packed once per stencil), each item's
// 68-row source window and chunk come into shared memory by cp.async,
// double buffered, the theta wrap done in the staging (window row
// h stands for state row (h - 2) mod nt), and items combine into out by
// atomicMin on the bits of non-negative floats.  The grid is the number
// of blocks the card holds at once (two of 86 KB an SM in float32), each
// with an equal run of the items.

#include <cuda_runtime.h>

#include "lane_gather.cuh"

namespace {

using lane_gather::chunk_bytes;
using lane_gather::kLanes;
using lane_gather::kThreads;
using lane_gather::window_bytes;

template <typename T>
struct RelaxArgs {
  static constexpr bool kFused = false;  // lane_gather::relax_run's sweep form
  const T* src;  // (T, SR, 128) the state before the sweep
  T* out;        // (T, SR, 128) the state after it
  const int* ck_info;
  const int* ck_row;
  const int* ck_idx;
  const T* ck_w;
  int t_tiles, nt, ntp, s_count, n_chunks;
};

template <typename T>
constexpr size_t smem_bytes() {
  return 2 * static_cast<size_t>(window_bytes<T>()) + 2 * static_cast<size_t>(chunk_bytes<T>());
}

// out = the input's real rows, +inf on the pad rows
template <typename T>
__global__ void init_kernel(const T* __restrict__ src, T* __restrict__ out, size_t n, int nt,
                            int ntp) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>((e / kLanes) % ntp);
    out[e] = c < nt ? src[e] : minplus::pos_inf<T>();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) relax_kernel(RelaxArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  lane_gather::relax_run<T>(a, a.out, smem_raw, smem_raw + 2 * window_bytes<T>(), false);
  cp_async_wait_all();  // no copy may outlive the block
}

// the blocks the card holds at once, found once a device (the queries
// cost the host more than a small sweep takes on the card)
template <typename T>
cudaError_t resident_blocks(int* blocks) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(relax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<T>()));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_kernel<T>, kThreads,
                                                      smem_bytes<T>());
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (dev < kDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <typename T>
int run(RelaxArgs<T> a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T>();
  int resident = 0;
  cudaError_t e = resident_blocks<T>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(a.t_tiles) * a.s_count * a.ntp * kLanes;
  const int init_blocks = static_cast<int>((n + 4 * kThreads - 1) / (4 * kThreads));
  init_kernel<T><<<init_blocks, kThreads, 0, st>>>(a.src, a.out, n, a.nt, a.ntp);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int items = lane_gather::relax_items(a.n_chunks, a.s_count, a.ntp);
  const int grid = items < resident ? items : resident;
  if (grid > 0) relax_kernel<T><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sweep on `stream`; returns the CUDA error of the launches as an
// int (0 when accepted).  dist and out are (t_tiles, s_count * ntp, 128)
// of float32 (is_double == 0) or float64, not overlapping; the chunk
// tables of fused_circulant.relax_chunks: ck_info (n_chunks, 2), ck_row
// (n_chunks, 32), ck_idx (n_chunks, 32, 32) int32 and ck_w (n_chunks, 32,
// 32) of the state's type; all contiguous device memory of the current
// device.
extern "C" int relax_launch(const void* dist, const void* ck_info, const void* ck_row,
                            const void* ck_idx, const void* ck_w, void* out, int t_tiles,
                            int nt, int s_count, int ntp, int n_chunks, int is_double,
                            void* stream) {
  // ck_info packs t * 4 + slab and the source tile in 16 bits each
  if (t_tiles < 1 || t_tiles * lane_gather::kSlabs > 0xffff || s_count < 1 || nt < 3 ||
      nt > ntp || ntp % 8 != 0 || n_chunks < 0 ||
      static_cast<long long>(t_tiles) * s_count * ntp * kLanes > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(ck_info);
  const int* cr = static_cast<const int*>(ck_row);
  const int* cx = static_cast<const int*>(ck_idx);
  if (is_double)
    return run<double>(RelaxArgs<double>{static_cast<const double*>(dist),
                                         static_cast<double*>(out), ci, cr, cx,
                                         static_cast<const double*>(ck_w), t_tiles, nt, ntp,
                                         s_count, n_chunks},
                       st);
  return run<float>(RelaxArgs<float>{static_cast<const float*>(dist), static_cast<float*>(out),
                                     ci, cr, cx, static_cast<const float*>(ck_w), t_tiles, nt,
                                     ntp, s_count, n_chunks},
                    st);
}
