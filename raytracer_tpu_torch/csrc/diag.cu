// One relaxation sweep of the diagonal-band stencil (the 'diag' engine),
// and the engine's centre fan and changed test after it.
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/diag_circulant.py
// _make_diag_kernel / _sweep_diag, and the fan and changed test of the
// loop around it (_solve_diag_jit, XLA ops there).  Python wrapper and
// plain PyTorch twin: raytracer_tpu_torch/ops/diag_circulant.py
// (diag_sweep and diag_step, diag_sweep_reference and diag_step_reference;
// diag_tiles_reference replays this file's work partition).  The ring and
// chain scans of the loop are csrc/diag_scans.cuh's kernels, which
// diag_launch runs first when it is given their tables (diag_step with
// scan=True: the whole iteration in one call), and ring_scan_launch and
// chain_scan_launch alone.
//
// What it computes.  The field is (Mp, NTL) float32 or float64: row m is
// slot m, lane c < nt is theta c, lanes [nt, NTL) are padding.  For the
// finite taps (dm, dc, w) of row m (w its weight for row m, m + dm in
// [0, Mp); diag_circulant.diag_tap_lists),
//   y[m, c] = min(x[m, c], min over the taps of x[m + dm, (c + dc) mod nt] + w)
// for c < nt, and y = +inf on lanes c >= nt.  Each candidate is one add
// (__fadd_rn / __dadd_rn) and min does not depend on order, so this gives
// the TPU kernel's floats; a +inf weight gives a +inf candidate, so the
// taps whose weight is +inf are left out.  With the fan (diag_step):
//   dcen' = min(dcen, min over (m, c) of y[m, c] + fan[m]),
//   y[m, c] = min(y[m, c], dcen' + fan[m]) for c < nt,
//   changed = any(y < old - tol) or dcen' < dcen - tol,
// the loop body's ops in its order (old is the iteration's field before
// its scans), so the solve takes the JAX package's iterations.  Rounding
// is monotone, so min over c of (y + f) == (min over c of y) + f: the
// minimum may be taken in any order and grouping.
//
// What bounds it on an H100.  At 127x63 (Mp = 1032, NTL = 128, nt = 127,
// 208,436 finite (row, diagonal) weights, ~200 a row) one sweep does
// 2 x 127 x 2.08e5 = 5.3e7 add and min operations, 0.8 us at 67 TFLOP/s
// f32 (H100 SXM data sheet, for a card at its 700 W power limit), and
// must move the field in and out and the finite weights with their
// indices once, about 2.7 MB, 0.8 us at 3.35 TB/s.  chip_smoke.py
// recomputes the bound from its run's inputs.  The first form of this
// file (one thread a point looping over all 534 diagonals with a branch
// on +inf, each field value read ~200 times from L1/L2) took 0.085-0.091
// ms a sweep there on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
// and the fan and changed test around it were ~15 torch ops.
//
// Design: the band of csrc/witer.cu.  A block takes kRows slot rows x LW
// lanes (a warp a row, LW / 32 lanes a thread).  The field window
// (kRows + 2 * halo rows x LW + 8 lanes, halo = the stencil's row
// padding >= max |dm|) comes into shared memory by cp.async: rows outside
// [0, Mp) hold +inf, and every window lane p holds lane p mod nt, so a
// tap's lane wraps mod nt in the window's addressing.  The rows' taps come
// in beside it as (window offset, w): a tap is one shared-memory
// broadcast and one shared-memory read a lane, no branch.  Where window
// and taps do not fit in 227 KB, LW halves to 32; where they do not then
// either, the taps are read from global memory.  With the fan, each
// block writes the minimum of its y + fan to `part`, and a second kernel
// (every block reduces `part` itself) applies the fan and sets the
// changed flag, which the first kernel cleared.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "diag_scans.cuh"
#include "minplus.cuh"

namespace {

constexpr int kRows = 8;       // rows (warps) of a sweep block
constexpr int kLaneHalo = 4;   // window lanes each side of a tile
constexpr int kFanThreads = 256;
constexpr size_t kSmemBudget = 227 * 1024;

using minplus::add_rn;
using minplus::is_inf;
using minplus::min_of;
using minplus::pos_inf;
using minplus::warp_min;

template <typename T>
struct Tap {
  int off;  // dm * window width + dc
  T w;
};

__device__ __forceinline__ int mod_nt(int p, int nt) {
  p %= nt;
  return p < 0 ? p + nt : p;
}

// grid (ceil(mp / kRows), ntl / (32 * LPT)): the sweep of kRows rows x
// 32 * LPT lanes, x -> y; with `part`, the block's min(y + fan) into
// part[block] and (block 0) the changed flag cleared.  The block's taps
// (at most tap_cap) are staged in shared memory beside the window; with
// tap_cap == 0 each is read from global memory where it is used.
template <typename T, int LPT>
__global__ void __launch_bounds__(kRows * 32)
sweep_kernel(const T* __restrict__ x, const int* __restrict__ tap_ptr,
             const int* __restrict__ tap_dmdc, const T* __restrict__ tap_w,
             const T* __restrict__ fan, T* __restrict__ y, T* part, int* flag, int mp, int ntl,
             int nt, int halo, int tap_cap) {
  constexpr int kLW = 32 * LPT;
  constexpr int kWW = kLW + 2 * kLaneHalo;
  constexpr int kVec = 16 / sizeof(T);  // values of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int wrows = kRows + 2 * halo;
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(
      smem_raw + (static_cast<size_t>(wrows) * kWW * sizeof(T) + 15) / 16 * 16);
  const int m0 = blockIdx.x * kRows;
  const int l0 = blockIdx.y * kLW;
  if (flag != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *flag = 0;

  // the window: row r is slot m0 - halo + r, column q is lane
  // (l0 - 4 + q) mod nt
  const T inf = pos_inf<T>();
  constexpr int kChunks = kWW / kVec;
  for (int i = threadIdx.x; i < wrows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, q = (i - r * kChunks) * kVec;
    const int g = m0 - halo + r;
    const int lp = l0 - kLaneHalo + q;
    T* d = win + static_cast<size_t>(r) * kWW + q;
    if (g < 0 || g >= mp) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) d[v] = inf;
    } else if (lp >= 0 && lp + kVec <= nt) {
      cp_async16(d, x + static_cast<size_t>(g) * ntl + lp);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        cp_async_ca<sizeof(T)>(d + v, x + static_cast<size_t>(g) * ntl + mod_nt(lp + v, nt));
    }
  }
  cp_async_commit();
  // a tap as (offset in the window, weight)
  auto tap_at = [&](int e) {
    const int dmdc = tap_dmdc[e];
    const int dm = dmdc >> 16;                       // arithmetic shift
    const int dc = static_cast<int>(static_cast<short>(dmdc & 0xffff));
    return Tap<T>{dm * kWW + dc, tap_w[e]};
  };
  const int e0 = tap_ptr[min(m0, mp)];
  const int e1 = tap_ptr[min(m0 + kRows, mp)];
  for (int e = e0 + threadIdx.x; e < e1 && e - e0 < tap_cap; e += blockDim.x)
    taps[e - e0] = tap_at(e);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = m0 + warp;
  T fmin = inf;
  if (m < mp) {
    const T* c0 = win + static_cast<size_t>(halo + warp) * kWW + kLaneHalo + lane;
    T acc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[j] = c0[32 * j];
    auto relax = [&](const Tap<T> t) {
      const T* p = c0 + t.off;
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = min_of(acc[j], add_rn(p[32 * j], t.w));
    };
    if (tap_cap > 0) {
      const int k1 = tap_ptr[m + 1] - e0;
#pragma unroll 4
      for (int k = tap_ptr[m] - e0; k < k1; ++k) relax(taps[k]);
    } else {
      const int e1m = tap_ptr[m + 1];
#pragma unroll 4
      for (int e = tap_ptr[m]; e < e1m; ++e) relax(tap_at(e));
    }
    T* yr = y + static_cast<size_t>(m) * ntl + l0 + lane;
    const T f = part != nullptr ? fan[m] : inf;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const bool real = l0 + lane + 32 * j < nt;
      yr[32 * j] = real ? acc[j] : inf;
      if (real && !is_inf(f)) fmin = min_of(fmin, add_rn(acc[j], f));
    }
  }
  if (part == nullptr) return;  // no block barrier below
  fmin = warp_min(fmin);
  __syncthreads();  // every warp is done with the window: its first row
  if (lane == 0) win[warp] = fmin;  // takes the warps' minima
  __syncthreads();
  if (threadIdx.x == 0) {
    T v = win[0];
#pragma unroll
    for (int w = 1; w < kRows; ++w) v = min_of(v, win[w]);
    part[blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// every block: dcen' = min(cen_in, min(part)); then, over the points of
// its grid stride, y = min(y, dcen' + fan[m]) on lanes c < nt and the
// changed test against `old`; block 0 writes cen_out and tests the
// centre.
template <typename T>
__global__ void __launch_bounds__(kFanThreads)
fan_kernel(T* __restrict__ y, const T* __restrict__ old, const T* __restrict__ part, int n_part,
           const T* __restrict__ cen_in, T* cen_out, const T* __restrict__ fan,
           const T* __restrict__ tol, int* flag, int mp, int ntl, int nt) {
  __shared__ T red[kFanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v = pos_inf<T>();
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) v = min_of(v, part[i]);
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const T c_old = cen_in[0];
  T dcen = c_old;
#pragma unroll
  for (int w = 0; w < kFanThreads / 32; ++w) dcen = min_of(dcen, red[w]);
  const T tl = tol[0];
  bool changed = false;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    cen_out[0] = dcen;
    changed = dcen < minplus::sub_rn(c_old, tl);
  }
  const size_t n = static_cast<size_t>(mp) * ntl;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(i / ntl), c = static_cast<int>(i - static_cast<size_t>(m) * ntl);
    T d = y[i];
    if (c < nt) {
      d = min_of(d, add_rn(dcen, fan[m]));
      y[i] = d;
    }
    changed |= d < minplus::sub_rn(old[i], tl);
  }
  if (__any_sync(0xffffffffu, changed) && lane == 0) *flag = 1;
}

template <typename T>
size_t sweep_smem(int lpt, int halo, int tap_cap) {
  const size_t win = static_cast<size_t>(kRows + 2 * halo) * (32 * lpt + 2 * kLaneHalo) *
                     sizeof(T);
  return (win + 15) / 16 * 16 + static_cast<size_t>(tap_cap) * sizeof(Tap<T>);
}

template <typename T, int LPT>
cudaError_t launch_sweep(const T* x, const int* tap_ptr, const int* tap_dmdc, const T* tap_w,
                         const T* fan, T* y, T* part, int* flag, int mp, int ntl, int nt,
                         int halo, int tap_cap, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(sweep_kernel<T, LPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((mp + kRows - 1) / kRows, ntl / (32 * LPT));
  sweep_kernel<T, LPT><<<grid, kRows * 32, smem, st>>>(x, tap_ptr, tap_dmdc, tap_w, fan, y, part,
                                                       flag, mp, ntl, nt, halo, tap_cap);
  return cudaGetLastError();
}

template <typename T>
int run(const T* dist, const int* tap_ptr, const int* tap_dmdc, const T* tap_w, T* out, int mp,
        int ntl, int nt, int halo, int block_taps, int lanes, const T* fan, const T* old,
        const T* cen_in, T* cen_out, const T* tol, T* part, int* flag, const T* rf, const T* rb,
        const T* tree_f, const T* tree_b, T* work, int ring_warps, int chain_cols,
        cudaStream_t st) {
  // the tile diag_circulant.diag_launch_plan chose: 64 or 32 lanes, the
  // block's taps staged (block_taps) or read from global memory (0)
  const int lpt = lanes / 32;
  const size_t smem = sweep_smem<T>(lpt, halo, block_taps);
  if ((lpt != 1 && lpt != 2) || ntl % lanes || smem > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (rf != nullptr) {  // the iteration's scans first: dist -> work -> work + mp * ntl
    T* ringed = work;
    T* chained = work + static_cast<size_t>(mp) * ntl;
    if ((e = diag_scans::ring(dist, rf, rb, ringed, mp, ntl, nt, ring_warps, st)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = diag_scans::chain(static_cast<const T*>(ringed), tree_f, tree_b, chained, mp, ntl,
                               chain_cols, st)) != cudaSuccess)
      return static_cast<int>(e);
    dist = chained;
  }
  e = lpt == 2 ? launch_sweep<T, 2>(dist, tap_ptr, tap_dmdc, tap_w, fan, out, part, flag, mp, ntl,
                                    nt, halo, block_taps, smem, st)
               : launch_sweep<T, 1>(dist, tap_ptr, tap_dmdc, tap_w, fan, out, part, flag, mp, ntl,
                                    nt, halo, block_taps, smem, st);
  if (e != cudaSuccess || part == nullptr) return static_cast<int>(e);
  const int n_part = ((mp + kRows - 1) / kRows) * (ntl / lanes);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const long long pts = (static_cast<long long>(mp) * ntl + kFanThreads - 1) / kFanThreads;
  const int fan_blocks = static_cast<int>(pts < 2LL * sms ? pts : 2LL * sms);
  fan_kernel<T><<<fan_blocks, kFanThreads, 0, st>>>(out, old, part, n_part, cen_in, cen_out, fan,
                                                    tol, flag, mp, ntl, nt);
  return static_cast<int>(cudaGetLastError());
}

bool bad_field(int mp, int ntl, int nt) {
  return mp < 1 || nt < 1 || nt > ntl || ntl % 128 ||
         static_cast<long long>(mp) * ntl >= (1LL << 31);
}

}  // namespace

// One sweep on `stream`; returns the first CUDA error as an int (0 when
// every launch was accepted).  dist (mp, ntl) is read only, out (mp, ntl)
// receives the result.  The taps, packed per row by
// diag_circulant.diag_tap_lists: tap_ptr (mp+1,) int32 the first entry of
// each row, tap_dmdc (E,) int32 dm << 16 | (dc & 0xffff) with |dm| <= halo
// and |dc| <= 4, tap_w (E,) the weights.  lanes (64 or 32) and block_taps
// (the most entries of kRows consecutive rows from a multiple of kRows,
// or 0 to read the taps from global memory) as diag_launch_plan chose.
// With fan != null also the fan and changed test: old (mp, ntl) the
// iteration's field before its scans, cen_in/cen_out/tol scalars, fan
// (mp,), part (ceil(mp / 8) * ntl / lanes,) work space, flag one int32
// (0 unchanged, 1 changed).  With rf != null first the ring and chain
// scans of dist (ring_scan_launch's and chain_scan_launch's arguments;
// work (2, mp, ntl) work space), the sweep then reading their result.
// All contiguous device memory, float32 (is_double == 0) or float64
// apart from the int32 tables; ntl a multiple of 128.
extern "C" int diag_launch(const void* dist, const void* tap_ptr, const void* tap_dmdc,
                           const void* tap_w, void* out, int mp, int ntl, int nt, int halo,
                           int block_taps, int lanes, const void* fan, const void* old,
                           const void* cen_in, void* cen_out, const void* tol, void* part,
                           void* flag, const void* rf, const void* rb, const void* tree_f,
                           const void* tree_b, void* work, int ring_warps, int chain_cols,
                           int is_double, void* stream) {
  if (bad_field(mp, ntl, nt) || halo < 0 || block_taps < 0 ||
      (fan != nullptr && (old == nullptr || cen_in == nullptr || cen_out == nullptr ||
                          tol == nullptr || part == nullptr || flag == nullptr)) ||
      (rf != nullptr && (rb == nullptr || tree_f == nullptr || tree_b == nullptr ||
                         work == nullptr || ring_warps < 1 ||
                         ring_warps > diag_scans::kRingWarps || chain_cols < 1 ||
                         ntl % chain_cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tap_ptr);
  const int* td = static_cast<const int*>(tap_dmdc);
  int* fl = static_cast<int*>(flag);
  if (is_double)
    return run<double>(static_cast<const double*>(dist), tp, td, static_cast<const double*>(tap_w),
                       static_cast<double*>(out), mp, ntl, nt, halo, block_taps, lanes,
                       static_cast<const double*>(fan), static_cast<const double*>(old),
                       static_cast<const double*>(cen_in), static_cast<double*>(cen_out),
                       static_cast<const double*>(tol),
                       fan != nullptr ? static_cast<double*>(part) : nullptr, fl,
                       static_cast<const double*>(rf), static_cast<const double*>(rb),
                       static_cast<const double*>(tree_f), static_cast<const double*>(tree_b),
                       static_cast<double*>(work), ring_warps, chain_cols, st);
  return run<float>(static_cast<const float*>(dist), tp, td, static_cast<const float*>(tap_w),
                    static_cast<float*>(out), mp, ntl, nt, halo, block_taps, lanes,
                    static_cast<const float*>(fan), static_cast<const float*>(old),
                    static_cast<const float*>(cen_in), static_cast<float*>(cen_out),
                    static_cast<const float*>(tol),
                    fan != nullptr ? static_cast<float*>(part) : nullptr, fl,
                    static_cast<const float*>(rf), static_cast<const float*>(rb),
                    static_cast<const float*>(tree_f), static_cast<const float*>(tree_b),
                    static_cast<float*>(work), ring_warps, chain_cols, st);
}

// The ring scan on `stream`; returns the CUDA error of the launch as an
// int (0 when accepted).  x and out (mp, ntl), rf and rb (mp,) the hop
// costs; `warps` rows a block (diag_circulant.scan_launch_plan: 2 x ntl
// values a warp must fit in a block's shared memory).  Contiguous device
// memory, float32 (is_double == 0) or float64.
extern "C" int ring_scan_launch(const void* x, const void* rf, const void* rb, void* out, int mp,
                                int ntl, int nt, int warps, int is_double, void* stream) {
  if (bad_field(mp, ntl, nt) || warps < 1 || warps > diag_scans::kRingWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(diag_scans::ring<double>(
        static_cast<const double*>(x), static_cast<const double*>(rf),
        static_cast<const double*>(rb), static_cast<double*>(out), mp, ntl, nt, warps, st));
  return static_cast<int>(diag_scans::ring<float>(
      static_cast<const float*>(x), static_cast<const float*>(rf), static_cast<const float*>(rb),
      static_cast<float*>(out), mp, ntl, nt, warps, st));
}

// The chain scan on `stream`; returns the CUDA error of the launch as an
// int.  x and out (mp, ntl); tree_f and tree_b the forward and backward
// sum trees of diag_circulant.chain_sum_tree (every level l with
// floor(mp / 2^l) >= 2 values, in order); `cols` lane columns a block
// (a divisor of ntl; 2 x mp x cols values must fit in a block's shared
// memory).  Contiguous device memory, float32 (is_double == 0) or float64.
extern "C" int chain_scan_launch(const void* x, const void* tree_f, const void* tree_b, void* out,
                                 int mp, int ntl, int cols, int is_double, void* stream) {
  if (bad_field(mp, ntl, 1) || cols < 1 || ntl % cols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(diag_scans::chain<double>(
        static_cast<const double*>(x), static_cast<const double*>(tree_f),
        static_cast<const double*>(tree_b), static_cast<double*>(out), mp, ntl, cols, st));
  return static_cast<int>(diag_scans::chain<float>(
      static_cast<const float*>(x), static_cast<const float*>(tree_f),
      static_cast<const float*>(tree_b), static_cast<float*>(out), mp, ntl, cols, st));
}
