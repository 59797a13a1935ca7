// The whole circulant solve in one cooperative launch (the 'fused'
// engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/contrib/fused_circulant.py
// _make_fused_kernel / _fused_jit.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/contrib/fused_circulant.py (fused,
// fused_reference).
//
// What it computes.  The state is (T, SR, 128) with SR = S * ntp rows
// (csrc/lane_gather.cuh), the centre one value per source.  Until no
// value falls (or max_iters), each iteration
//   1. snapshots the state into `old` and source 0's centre;
//   2. ring scan: for every (tile, source, lane) ring of nt theta rows
//      and shift = 1, 2, 4, ... 128 with sh = shift mod nt != 0,
//        v[c] = min(v[c], min(v[(c+sh) mod nt], v[(c-sh) mod nt])
//                         + ring_w * shift)
//      Jacobi within each step (the cost times the unreduced shift);
//   3. chain scan along the flat slot m = t*128 + lane of every row, for
//      s = 1, 2, ... 64: v[m] = min(v[m], v[m-s] + pdn[k][m]), then
//      v[m] = min(v[m], v[m+s] + pup[k][m]), +inf past either end, each a
//      Jacobi step; the result goes to `src`;
//   4. lane-gather relaxation of `src` into the state (the dc = 0 copy is
//      `src` itself, pad rows included);
//   5. centre fan: cen[s] = min(cen[s], min over real rows and lanes of
//      state + fan_w), then state = min(state, cen[s] + fan_w) on all
//      ntp rows of source s;
//   6. changed = cen[0] < old cen[0] or any(state < old).
// Every add is __fadd_rn / __dadd_rn and the one multiply __fmul_rn /
// __dmul_rn (by a power of two, so exact), nothing for nvcc to contract;
// minima do not depend on order.  So the result is the plain version's
// and the Pallas kernel's to the bit, float32 or float64.
//
// Design.  The TPU kernel kept the state in VMEM for the whole loop.
// Here one cooperative launch (grid = resident blocks per SM x SMs, from
// the occupancy calculator) runs the loop; every phase is a grid-stride
// loop and a grid sync separates dependent phases (4 per iteration:
// the snapshot rides on the ring phase and the fan's reduction on the
// relaxation).  The state, the snapshot and the relaxation's source
// live in device memory and stay in the 50 MB L2 (0.66 MB each per
// source at 180x63).  A ring tile (nt rows x up to 32 lanes) and a
// row's T*128 chain slots run their steps in shared memory with block
// barriers.  The centre's grid-wide minimum is an atomicMin on the bits
// of non-negative floats (their order is the integers'), exact and
// order-free.  The changed flag is double-buffered: iteration i sets
// flags[i & 1] and clears flags[(i + 1) & 1] after its first grid sync,
// when every block has read the previous iteration's flag.
//
// What bounds it on an H100.  Per iteration at 180x63, S = 1: an add
// and a min for each of the 24.6 M candidates whose weight is finite (of
// 64 M), plus the scans over 0.16 M values (8 + 14 steps): operations
// bound it (the solve's bytes are the tables and the state once).
// chip_smoke.py computes the bound from its run's inputs and the
// iteration count the kernel returns.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lane_gather.cuh"

namespace cg = cooperative_groups;

namespace {

using lane_gather::add_rn;
using lane_gather::is_inf;
using lane_gather::kLanes;
using lane_gather::kRows;
using lane_gather::pos_inf;

constexpr int kThreads = 256;
constexpr int kRingSteps = 8;
constexpr int kChainSteps = 7;
constexpr size_t kRingSmemTarget = 48 * 1024;
constexpr size_t kSmemBudget = 227 * 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// min of non-negative floats (+0 .. +inf): their bit patterns order as
// unsigned integers
__device__ __forceinline__ void atomic_min_nonneg(float* a, float v) {
  atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min_nonneg(double* a, double v) {
  atomicMin(reinterpret_cast<unsigned long long*>(a),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

template <typename T>
struct FusedArgs {
  T* state;  // (T, SR, 128) in: the initial state, out: the solution
  T* cen;    // (S,) in: initial centre values, out: the solution
  T* old;    // (T, SR, 128) scratch: the iteration's snapshot
  T* src;    // (T, SR, 128) scratch: the scanned state, relaxation source
  const int* offs;
  const int* u_of;
  const int* idx;
  const T* w;
  const T* ring_w;  // (T, 128)
  const T* pdn;     // (7, T*128)
  const T* pup;     // (7, T*128)
  const T* fan_w;   // (T, 128)
  int* flags;       // (2,) zero on entry
  int* iters;       // () out: iterations run
  int t_tiles, nt, ntp, s_count, max_iters, lg;
};

// 1 + 2: snapshot every row into `old`, ring-scan the real rows in place
template <typename T>
__device__ void ring_phase(const FusedArgs<T>& a, T* sm, int sr) {
  const int lg = a.lg, nt = a.nt, ntp = a.ntp;
  const int ngroups = kLanes / lg;
  const int items = a.t_tiles * a.s_count * ngroups;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item % ngroups;
    const int s = (item / ngroups) % a.s_count;
    const int t = item / (ngroups * a.s_count);
    const int lane0 = g * lg;
    const size_t base = t * tile + static_cast<size_t>(s) * ntp * kLanes + lane0;
    T* A = sm;
    T* B = sm + nt * lg;
    for (int e = threadIdx.x; e < ntp * lg; e += blockDim.x) {
      const int c = e / lg;
      const size_t gi = base + static_cast<size_t>(c) * kLanes + (e - c * lg);
      const T v = a.state[gi];
      a.old[gi] = v;
      if (c < nt) A[e] = v;
    }
    __syncthreads();
    int shift = 1;
    for (int k = 0; k < kRingSteps; ++k, shift *= 2) {
      const int sh = shift % nt;
      if (sh == 0) continue;  // a whole-ring shift is a no-op
      for (int e = threadIdx.x; e < nt * lg; e += blockDim.x) {
        const int c = e / lg;
        const int l = e - c * lg;
        const int cf = c + sh >= nt ? c + sh - nt : c + sh;
        const int cb = c - sh < 0 ? c - sh + nt : c - sh;
        const T f = A[cf * lg + l];
        const T b = A[cb * lg + l];
        const T cand = add_rn(f < b ? f : b,
                              mul_rn(a.ring_w[t * kLanes + lane0 + l], static_cast<T>(shift)));
        const T v = A[e];
        B[e] = cand < v ? cand : v;
      }
      __syncthreads();
      T* tmp = A;
      A = B;
      B = tmp;
    }
    for (int e = threadIdx.x; e < nt * lg; e += blockDim.x) {
      const int c = e / lg;
      a.state[base + static_cast<size_t>(c) * kLanes + (e - c * lg)] = A[e];
    }
    __syncthreads();  // the next item reuses the tile
  }
}

// 3: chain-scan every row (pad rows too) from the state into `src`
template <typename T>
__device__ void chain_phase(const FusedArgs<T>& a, T* sm, int sr) {
  const int n = a.t_tiles * kLanes;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  for (int r = blockIdx.x; r < sr; r += gridDim.x) {
    T* A = sm;
    T* B = sm + n;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      A[e] = a.state[(e / kLanes) * tile + static_cast<size_t>(r) * kLanes + e % kLanes];
    __syncthreads();
    for (int k = 0; k < kChainSteps; ++k) {
      const int s = 1 << k;
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const T cand = add_rn(e >= s ? A[e - s] : pos_inf<T>(), a.pdn[k * n + e]);
        const T v = A[e];
        B[e] = cand < v ? cand : v;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const T cand = add_rn(e + s < n ? B[e + s] : pos_inf<T>(), a.pup[k * n + e]);
        const T v = B[e];
        A[e] = cand < v ? cand : v;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      a.src[(e / kLanes) * tile + static_cast<size_t>(r) * kLanes + e % kLanes] = A[e];
    __syncthreads();
  }
}

// 4 + 5a: relax `src` into the state; fold the real rows' fan candidates
// into cen
template <typename T>
__device__ void relax_phase(const FusedArgs<T>& a, int sr) {
  const int groups = sr / kRows;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  const long long total = static_cast<long long>(a.t_tiles) * groups * kLanes;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lane = static_cast<int>(e % kLanes);
    const long long rest = e / kLanes;
    const int r0 = static_cast<int>(rest % groups) * kRows;
    const int t = static_cast<int>(rest / groups);
    T acc[kRows];
    lane_gather::relax_rows<T, true>(a.src, a.offs, a.u_of, a.idx, a.w, t, r0, lane,
                                     a.t_tiles, a.nt, a.ntp, sr, acc);
    const T fw = a.fan_w[t * kLanes + lane];
    const int s = r0 / a.ntp;
    const int c0 = r0 - s * a.ntp;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      a.state[t * tile + static_cast<size_t>(r0 + i) * kLanes + lane] = acc[i];
      if (c0 + i < a.nt && !is_inf(fw)) {
        const T cand = add_rn(acc[i], fw);
        if (cand < __ldcg(a.cen + s)) atomic_min_nonneg(a.cen + s, cand);
      }
    }
  }
}

// 5b + 6: state = min(state, cen + fan_w) on every row; raise the flag
// where a value fell below the snapshot
template <typename T>
__device__ void fan_phase(const FusedArgs<T>& a, int sr, int* flag, T old_cen0) {
  const long long total = static_cast<long long>(a.t_tiles) * sr * kLanes;
  bool fell = false;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lane = static_cast<int>(e % kLanes);
    const int r = static_cast<int>((e / kLanes) % sr);
    const int t = static_cast<int>(e / (static_cast<long long>(kLanes) * sr));
    const T cand = add_rn(__ldcg(a.cen + r / a.ntp), a.fan_w[t * kLanes + lane]);
    const T v = a.state[e];
    const T nv = cand < v ? cand : v;
    a.state[e] = nv;
    fell |= nv < a.old[e];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && __ldcg(a.cen) < old_cen0) fell = true;
  if (fell) *reinterpret_cast<volatile int*>(flag) = 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_kernel(FusedArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int sr = a.s_count * a.ntp;
  int it = 0;
  while (it < a.max_iters) {
    int* flag = a.flags + (it & 1);
    const T old_cen0 = __ldcg(a.cen);
    ring_phase(a, sm, sr);
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) a.flags[(it + 1) & 1] = 0;
    chain_phase(a, sm, sr);
    grid.sync();
    relax_phase(a, sr);
    grid.sync();
    fan_phase(a, sr, flag, old_cen0);
    grid.sync();
    ++it;
    if (*reinterpret_cast<volatile int*>(flag) == 0) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters = it;
}

template <typename T>
int run(FusedArgs<T> a, cudaStream_t st) {
  int lg = 32;
  while (lg > 1 && 2 * static_cast<size_t>(a.nt) * lg * sizeof(T) > kRingSmemTarget) lg /= 2;
  a.lg = lg;
  const size_t ring = 2 * static_cast<size_t>(a.nt) * lg;
  const size_t chain = 2 * static_cast<size_t>(a.t_tiles) * kLanes;
  const size_t smem = (ring > chain ? ring : chain) * sizeof(T);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel<T>),
                                  dim3(per_sm * sms), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole solve on `stream`, one cooperative launch; returns the CUDA
// error of the launch as an int (0 when accepted).  state (t_tiles,
// s_count * ntp, 128) and cen (s_count,) hold the initial values and
// receive the solution (updated in place); old and src are scratch of
// the state's size; offs, u_of, idx and w as for relax_launch
// (csrc/relax.cu); ring_w and fan_w (t_tiles, 128), pdn and pup
// (7, t_tiles * 128); flags (2,) int32 zeroed; iters () int32 receives
// the iteration count.  Values are float32 (is_double == 0) or float64,
// non-negative or +inf; all contiguous device memory of the current
// device.
extern "C" int fused_launch(void* state, void* cen, void* old, void* src,
                            const void* offs, const void* u_of, const void* idx,
                            const void* w, const void* ring_w, const void* pdn,
                            const void* pup, const void* fan_w, void* flags,
                            void* iters, int t_tiles, int nt, int ntp, int s_count,
                            int max_iters, int is_double, void* stream) {
  if (t_tiles < 1 || s_count < 1 || nt < 3 || nt > ntp || ntp % 8 != 0 ||
      static_cast<long long>(t_tiles) * s_count * ntp * kLanes > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    FusedArgs<double> a{static_cast<double*>(state), static_cast<double*>(cen),
                        static_cast<double*>(old), static_cast<double*>(src),
                        static_cast<const int*>(offs), static_cast<const int*>(u_of),
                        static_cast<const int*>(idx), static_cast<const double*>(w),
                        static_cast<const double*>(ring_w), static_cast<const double*>(pdn),
                        static_cast<const double*>(pup), static_cast<const double*>(fan_w),
                        static_cast<int*>(flags), static_cast<int*>(iters),
                        t_tiles, nt, ntp, s_count, max_iters, 0};
    return run<double>(a, st);
  }
  FusedArgs<float> a{static_cast<float*>(state), static_cast<float*>(cen),
                     static_cast<float*>(old), static_cast<float*>(src),
                     static_cast<const int*>(offs), static_cast<const int*>(u_of),
                     static_cast<const int*>(idx), static_cast<const float*>(w),
                     static_cast<const float*>(ring_w), static_cast<const float*>(pdn),
                     static_cast<const float*>(pup), static_cast<const float*>(fan_w),
                     static_cast<int*>(flags), static_cast<int*>(iters),
                     t_tiles, nt, ntp, s_count, max_iters, 0};
  return run<float>(a, st);
}
