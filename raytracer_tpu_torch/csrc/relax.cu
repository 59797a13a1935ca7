// One lane-gather relaxation sweep of the circulant stencil (the
// 'pallas' engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/contrib/pallas_circulant.py
// _make_relax_kernel / _relax_pallas.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/contrib/pallas_circulant.py (relax,
// relax_reference).
//
// What it computes: see csrc/lane_gather.cuh.  dist is (T, S*ntp, 128),
// out receives one sweep of it, pad rows at +inf.
//
// Design.  The TPU kernel took 5 theta-rolled copies of the state that
// XLA rebuilt before each sweep (5x the state through HBM) and ran one
// grid step per destination tile.  Here the roll is index arithmetic on
// the state itself: one thread per (tile, 4 rows of one source block,
// lane), threads along lanes, so the idx and w reads of a warp are
// coalesced and each serves 4 gathers; a gather reads one 512 B row of a
// source tile, held in L1/L2 (the state is 0.66 MB per source at
// 180x63).
//
// What bounds it on an H100.  At 180x63 (T = 7, nt = 180, ntp = 184,
// K_tot = 2,785) a sweep looks at 2,785 x 128 x 180 = 64 M candidates
// per source, one add and one min each where the weight is finite, and
// must move the state in and out and the tables once (about 4 MB at
// S = 1).  chip_smoke.py computes the bound from its run's inputs.  The
// w/idx rows are re-read by every row group (46 per tile at S = 1)
// through L2; more rows per thread, or the tile's rows in shared memory,
// are the levers beyond this simple first form.

#include <cuda_runtime.h>

#include "lane_gather.cuh"

namespace {

using lane_gather::kLanes;
using lane_gather::kRows;

constexpr int kGroupsPerBlock = 2;  // blockDim = (128 lanes, 2 row groups)

template <typename T>
__global__ void __launch_bounds__(kLanes * kGroupsPerBlock)
relax_kernel(const T* __restrict__ dist, const int* __restrict__ offs,
             const int* __restrict__ u_of, const int* __restrict__ idx,
             const T* __restrict__ w, T* __restrict__ out, int t_tiles,
             int nt, int ntp, int sr) {
  const int lane = threadIdx.x;
  const int g = blockIdx.x * kGroupsPerBlock + threadIdx.y;
  const int t = blockIdx.y;
  const int r0 = g * kRows;
  if (r0 >= sr) return;
  T acc[kRows];
  lane_gather::relax_rows<T>(dist, offs, u_of, idx, w, t, r0, lane, t_tiles, nt, ntp,
                             sr, acc);
  T* o = out + static_cast<size_t>(t) * sr * kLanes +
         static_cast<size_t>(r0) * kLanes + lane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) o[static_cast<size_t>(i) * kLanes] = acc[i];
}

template <typename T>
int run(const void* dist, const void* offs, const void* u_of,
        const void* idx, const void* w, void* out, int t_tiles, int nt,
        int ntp, int sr, cudaStream_t st) {
  const int groups = sr / kRows;
  const dim3 grid((groups + kGroupsPerBlock - 1) / kGroupsPerBlock, t_tiles);
  const dim3 block(kLanes, kGroupsPerBlock);
  relax_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(dist), static_cast<const int*>(offs),
      static_cast<const int*>(u_of), static_cast<const int*>(idx),
      static_cast<const T*>(w), static_cast<T*>(out), t_tiles, nt, ntp, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sweep on `stream`; returns the CUDA error of the launch as an int
// (0 when accepted).  dist and out are (t_tiles, s_count * ntp, 128) of
// float32 (is_double == 0) or float64, offs (t_tiles + 1,) int32 rising
// from 0 to k_tot, u_of (k_tot,) and idx (k_tot, 128) int32 with
// 0 <= u_of < 5 * t_tiles and 0 <= idx < 128, w (k_tot, 128) of the
// state's type; all contiguous device memory, dist and out not
// overlapping.
extern "C" int relax_launch(const void* dist, const void* offs,
                            const void* u_of, const void* idx, const void* w,
                            void* out, int t_tiles, int nt, int s_count,
                            int ntp, int is_double, void* stream) {
  if (t_tiles < 1 || s_count < 1 || nt < 3 || nt > ntp || ntp % 8 != 0 ||
      static_cast<long long>(t_tiles) * s_count * ntp * kLanes > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sr = s_count * ntp;
  return is_double ? run<double>(dist, offs, u_of, idx, w, out, t_tiles, nt,
                                 ntp, sr, st)
                   : run<float>(dist, offs, u_of, idx, w, out, t_tiles, nt,
                                ntp, sr, st);
}
