// The whole circulant solve in one cooperative launch (the 'fused'
// engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/contrib/fused_circulant.py
// _make_fused_kernel / _fused_jit.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/contrib/fused_circulant.py (fused,
// fused_reference).
//
// What it computes.  The state is (T, SR, 128) with SR = S * ntp rows
// (row s * ntp + c: theta column c of source s; rows c >= nt pad ntp to
// a multiple of 8), the centre one value per source.  Until no value
// falls (or max_iters), each iteration
//   1. snapshots the state and source 0's centre;
//   2. ring scan: for every (tile, source, lane) ring of nt theta rows
//      and shift = 1, 2, 4, ... 128 with sh = shift mod nt != 0,
//        v[c] = min(v[c], min(v[(c+sh) mod nt], v[(c-sh) mod nt])
//                         + ring_w * shift)
//      Jacobi within each step (the cost times the unreduced shift);
//   3. chain scan along the flat slot m = t*128 + lane of every row, for
//      s = 1, 2, ... 64: v[m] = min(v[m], v[m-s] + pdn[k][m]), then
//      v[m] = min(v[m], v[m+s] + pup[k][m]), +inf past either end, each a
//      Jacobi step;
//   4. lane-gather relaxation: every row takes the minimum of itself and
//      src[u, (c + dc) mod nt, idx[k, l]] + w[k, l] over the stencil rows
//      k of its tile (a pad row only over the dc = 0 rows, from its own
//      pad row);
//   5. centre fan: cen[s] = min(cen[s], min over real rows and lanes of
//      state + fan_w), then state = min(state, cen[s] + fan_w) on all
//      ntp rows of source s;
//   6. changed = cen[0] < old cen[0] or any(state < old).
// Every add is __fadd_rn / __dadd_rn and the one multiply __fmul_rn /
// __dmul_rn (by a power of two, so exact), nothing for nvcc to contract;
// minima do not depend on order, and rounding is monotone, so
// min(a, b) + f == min(a + f, b + f) to the bit.  So the result is the
// plain version's and the Pallas kernel's to the bit, float32 or
// float64, with the same iteration count.
//
// What bounds it on an H100.  The work is an add and a min for each of
// the 24.6 M candidates whose weight is finite per iteration at 180x63,
// S = 1 (0.15 ms for 170 iterations at 67 TFLOP/s f32), so the bound is
// operations.  What held the first design (0.66 ms an iteration on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit) was latency: a thread
// walked all 220-579 stencil rows of its tile as a chain of dependent
// L2 loads, on 41 k threads, and the relaxation took 0.56 ms of the
// iteration, the ring scan on 28 blocks 0.077 ms, a grid sync 1.6 us
// (tools/chip_kernel_ab.py --breakdown).  This design takes 31 us an
// iteration there (5.3 ms a solve): the relaxation, now about half of
// it, is held by the shared-memory loads and the block's item runs, the
// ring and chain scans by their block barriers, and three grid syncs.
//
// Design.  One cooperative launch (grid = resident blocks per SM x SMs,
// from the occupancy calculator) runs the loop in three phases with a
// grid sync after each:
//   A. fan of the previous iteration (state = min(state, cen + fan_w)),
//      its changed flag against the snapshot, the new snapshot, and the
//      ring scan.  A ring item is (tile, source, group of lg lanes), lg
//      a power of two chosen so that there are about as many items as
//      blocks; the ring runs its steps in shared memory.  The loop stops
//      after this phase when the flag of the previous iteration is clear
//      (or max_iters iterations ran): the snapshot then holds the result.
//   B. chain scan of each row in shared memory, the jump costs staged
//      there once per block; the result goes to the state and, with 2
//      wrapped theta rows above and below each source's nt real rows, to
//      `src` ((T, S, ntp + 4, 128)), so the relaxation's theta roll needs
//      no wrap; the real rows fold state + fan_w into the centre.
//   C. relaxation (csrc/lane_gather.cuh's relax_run, which csrc/relax.cu
//      shares).  The host packs each (tile, 32-lane slab, source
//      tile)'s stencil rows whose slab has a finite weight (59 % of the
//      rows at 180x63) into chunks of at most 32 rows, balanced in size,
//      dc = 0 rows first.  An item is (source, block of 64 theta rows,
//      chunk); block b takes an equal run of the item list.  Its 256
//      threads take an item as 8 warps x 32 lanes, 8 rows a thread, so
//      a weight and an index serve 8 gathers, each at a constant offset.
//      The item's source window (68 rows of `src`) and chunk tables come
//      into shared memory by cp.async, double buffered; the window is
//      reloaded only when it changes along the run, and the first
//      chunk's tables (constant) are fetched at the start of the
//      iteration.  Items of one tile combine by atomicMin on the bits of
//      non-negative floats (their order is the integers'), and fold
//      partial minima + fan_w into the centre the same way: exact and
//      order-free.
// The changed flag is double-buffered: phase A at loop index i sets
// flags[i & 1] and block 0 clears flags[(i + 1) & 1] after the grid
// sync that follows it, when every block has read the older flag.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "lane_gather.cuh"

namespace cg = cooperative_groups;

// Timing hook: tools/chip_kernel_ab.py --breakdown pre-includes a header
// that defines FUSED_SPLIT(k) to stamp block 0's %globaltimer after grid
// sync k of an iteration (k = -1: the start); empty in the package's
// build.
#ifndef FUSED_SPLIT
#define FUSED_SPLIT(k)
#endif

namespace {

using lane_gather::kHalo;
using lane_gather::kLanes;
using lane_gather::kThreads;
using lane_gather::window_bytes;
using lane_gather::chunk_bytes;
using minplus::add_rn;
using minplus::atomic_min_nonneg;
using minplus::is_inf;
using minplus::min_of;
using minplus::mul_rn;
using minplus::pos_inf;
using minplus::warp_min;

constexpr int kRingSteps = 8;
constexpr int kChainSteps = 7;
constexpr int kMinRingLanes = 4;
constexpr size_t kRingSmemTarget = 48 * 1024;
constexpr size_t kSmemBudget = 227 * 1024;

template <typename T>
struct FusedArgs {
  static constexpr bool kFused = true;  // lane_gather::relax_run's fused form
  T* state;  // (T, SR, 128) in: the initial state, out: the solution
  T* cen;    // (S,) in: initial centre values, out: the solution
  T* old;    // (T, SR, 128) scratch: the snapshot
  T* src;    // (T, S, ntp + 4, 128) scratch: the scanned state with halos
  const T* ring_w;   // (T, 128)
  const T* pdn;      // (7, T*128)
  const T* pup;      // (7, T*128)
  const T* fan_w;    // (T, 128)
  const int* ck_info;  // (n_chunks, 2): tile * 4 + slab | source tile << 16,
                       // rows | rows of dc = 0 (they come first) << 16
  const int* ck_row;   // (n_chunks, 32): source tile | (dc + 2) << 16
  const int* ck_idx;   // (n_chunks, 32, 32): source lane
  const T* ck_w;       // (n_chunks, 32, 32): weight (+inf: no edge)
  int* flags;       // (2,) zero on entry
  int* iters;       // () out: iterations run
  int t_tiles, nt, ntp, s_count, n_chunks, max_iters, lgs;
};

// the shared memory of a block: the ring, chain or window region, then
// two chunk buffers
template <typename T>
__host__ __device__ constexpr size_t region_bytes(int nt, int lg, int t_tiles) {
  const size_t ring = 2 * static_cast<size_t>(nt) * lg * sizeof(T);
  const size_t chain = (2 + 2 * kChainSteps) * static_cast<size_t>(t_tiles) * kLanes * sizeof(T);
  const size_t win = 2 * static_cast<size_t>(window_bytes<T>());
  const size_t most = ring > chain ? (ring > win ? ring : win) : (chain > win ? chain : win);
  return (most + 15) / 16 * 16;
}

// A: fan of the previous iteration (unless `first`), its changed flag,
// the snapshot, and the ring scan of the real rows in place
template <typename T>
__device__ void ring_phase(const FusedArgs<T>& a, T* sm, int sr, bool first, int* flag) {
  const int nt = a.nt, ntp = a.ntp, lgs = a.lgs, lg = 1 << lgs;
  const int gshift = 7 - lgs;  // log2 of the lane groups of a tile
  const int items = (a.t_tiles * a.s_count) << gshift;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  bool fell = false;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item & ((1 << gshift) - 1);
    const int ts = item >> gshift;
    const int s = ts % a.s_count;
    const int t = ts / a.s_count;
    const int lane0 = g << lgs;
    const size_t base = t * tile + static_cast<size_t>(s) * ntp * kLanes + lane0;
    // a thread's lane in the group is the same for all its elements
    // (blockDim.x is a multiple of lg)
    const int l = threadIdx.x & (lg - 1);
    const T rw = a.ring_w[t * kLanes + lane0 + l];
    const T f = first ? pos_inf<T>() : add_rn(__ldcg(a.cen + s), a.fan_w[t * kLanes + lane0 + l]);
    T* A = sm;
    T* B = sm + nt * lg;
    for (int e = threadIdx.x; e < ntp * lg; e += blockDim.x) {
      const int c = e >> lgs;
      const size_t gi = base + static_cast<size_t>(c) * kLanes + l;
      T v = a.state[gi];
      if (!first) {
        v = min_of(v, f);
        fell |= v < a.old[gi];
      }
      a.old[gi] = v;
      if (c < nt) A[e] = v;
      else a.state[gi] = v;
    }
    __syncthreads();
    int shift = 1;
    for (int k = 0; k < kRingSteps; ++k, shift *= 2) {
      const int sh = shift % nt;
      if (sh == 0) continue;  // a whole-ring shift is a no-op
      const T cost = mul_rn(rw, static_cast<T>(shift));
      for (int e = threadIdx.x; e < nt * lg; e += blockDim.x) {
        const int c = e >> lgs;
        const int cf = c + sh >= nt ? c + sh - nt : c + sh;
        const int cb = c - sh < 0 ? c - sh + nt : c - sh;
        B[e] = min_of(A[e], add_rn(min_of(A[(cf << lgs) + l], A[(cb << lgs) + l]), cost));
      }
      __syncthreads();
      T* tmp = A;
      A = B;
      B = tmp;
    }
    for (int e = threadIdx.x; e < nt * lg; e += blockDim.x)
      a.state[base + static_cast<size_t>(e >> lgs) * kLanes + (e & (lg - 1))] = A[e];
    __syncthreads();  // the next item reuses the tile
  }
  if (fell) *reinterpret_cast<volatile int*>(flag) = 1;
}

// B: chain-scan every row (pad rows too) into the state and the haloed
// `src`; fold the real rows' state + fan_w into the centre.  The jump
// costs pdn and pup come into shared memory once per block, with each
// row, by cp.async.
template <typename T>
__device__ void chain_phase(const FusedArgs<T>& a, unsigned char* smem, int sr) {
  const int n = a.t_tiles * kLanes;
  const int nt = a.nt, ntp = a.ntp, nth = a.ntp + 2 * kHalo;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  const size_t tileh = static_cast<size_t>(a.s_count) * nth * kLanes;
  constexpr int kVec = 16 / sizeof(T);  // values in a 16-byte copy
  T* A = reinterpret_cast<T*>(smem);
  T* B = A + n;
  T* P = B + n;  // pdn (kChainSteps x n), then pup
  for (int r = blockIdx.x; r < sr; r += gridDim.x) {
    if (r == static_cast<int>(blockIdx.x)) {
      for (int i = threadIdx.x; i < kChainSteps * n / kVec; i += blockDim.x) {
        cp_async16(P + kVec * i, a.pdn + kVec * i);
        cp_async16(P + kChainSteps * n + kVec * i, a.pup + kVec * i);
      }
    }
    for (int i = threadIdx.x; i < n / kVec; i += blockDim.x) {
      const int e = kVec * i;
      cp_async16(A + e, a.state + (e / kLanes) * tile + static_cast<size_t>(r) * kLanes +
                            e % kLanes);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int s = r / ntp;
    const int c = r - s * ntp;
    for (int k = 0; k < kChainSteps; ++k) {
      const int st = 1 << k;
      const T* pd = P + k * n;
      const T* pu = P + (kChainSteps + k) * n;
      for (int e = threadIdx.x; e < n; e += blockDim.x)
        B[e] = min_of(A[e], add_rn(e >= st ? A[e - st] : pos_inf<T>(), pd[e]));
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += blockDim.x)
        A[e] = min_of(B[e], add_rn(e + st < n ? B[e + st] : pos_inf<T>(), pu[e]));
      __syncthreads();
    }
    // src row of this row, and its wrapped copies for the rows within
    // kHalo of either end of the ring
    const size_t q0 = static_cast<size_t>(s) * nth;
    const size_t own = q0 + (c < nt ? c + kHalo : c + 2 * kHalo);
    const bool below = c < kHalo;                 // row c also at nt + 2 + c
    const bool above = c >= nt - kHalo && c < nt;  // row c also at c - nt + 2
    T cmin = pos_inf<T>();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const T v = A[e];
      const int t = e / kLanes;
      const int l = e % kLanes;
      a.state[t * tile + static_cast<size_t>(r) * kLanes + l] = v;
      T* row = a.src + t * tileh + l;
      row[own * kLanes] = v;
      if (below) row[(q0 + nt + kHalo + c) * kLanes] = v;
      if (above) row[(q0 + c - nt + kHalo) * kLanes] = v;
      if (c < nt) {
        const T fw = a.fan_w[e];
        if (!is_inf(fw)) cmin = min_of(cmin, add_rn(v, fw));
      }
    }
    cmin = warp_min(cmin);
    if ((threadIdx.x & 31) == 0 && !is_inf(cmin)) atomic_min_nonneg(a.cen + s, cmin);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_kernel(FusedArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  FUSED_SPLIT(-1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int sr = a.s_count * a.ntp;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int nrb = (a.ntp + lane_gather::kRowBlock - 1) / lane_gather::kRowBlock;
  const int n_items = lane_gather::relax_items(a.n_chunks, a.s_count, a.ntp);
  const int first = lane_gather::item_run(n_items, blockIdx.x);
  const bool has_items = first < lane_gather::item_run(n_items, blockIdx.x + 1);
  unsigned char* chunks = smem_raw + region_bytes<T>(a.nt, 1 << a.lgs, a.t_tiles);
  T cen0 = 0;  // lead: source 0's centre at the start of the iteration
  int it = 0;
  for (;;) {
    int* flag = a.flags + (it & 1);
    if (lead) {
      const T c = __ldcg(a.cen);
      if (it > 0 && c < cen0) *reinterpret_cast<volatile int*>(flag) = 1;
      cen0 = c;
    }
    if (has_items) {  // the first chunk's tables are constant: ahead of the phases
      lane_gather::stage_chunk<T>(a, lane_gather::decode_item(first, a.n_chunks, nrb).ch,
                                  chunks);
      cp_async_commit();
    }
    ring_phase(a, sm, sr, it == 0, flag);
    grid.sync();
    FUSED_SPLIT(0);
    // the snapshot holds iteration it - 1's result
    if (it > 0 && *reinterpret_cast<volatile int*>(flag) == 0) break;
    if (it == a.max_iters) break;
    if (lead) a.flags[(it + 1) & 1] = 0;
    chain_phase(a, smem_raw, sr);
    grid.sync();
    FUSED_SPLIT(1);
    lane_gather::relax_run<T>(a, a.state, smem_raw, chunks, true);
    grid.sync();
    FUSED_SPLIT(2);
    ++it;
  }
  cp_async_wait_all();  // the chunk prefetched for an iteration that did not run
  const size_t n = static_cast<size_t>(a.t_tiles) * sr * kLanes;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x)
    a.state[e] = a.old[e];
  if (lead) *a.iters = it;
}

template <typename T>
int run(FusedArgs<T> a, cudaStream_t st) {
  int lg_max = 32;
  while (lg_max > 1 && 2 * static_cast<size_t>(a.nt) * lg_max * sizeof(T) > kRingSmemTarget)
    lg_max /= 2;
  // the ring region shrinks with lg below, so the chunk buffers still fit
  const size_t smem = region_bytes<T>(a.nt, lg_max, a.t_tiles) + 2 * chunk_bytes<T>();
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
  const int grid = per_sm * sms;
  // ring lane groups: as many ring items as blocks, down to 4 lanes
  int lg = lg_max;
  while (lg > kMinRingLanes && a.t_tiles * a.s_count * (kLanes / lg) < grid) lg /= 2;
  a.lgs = 0;
  while ((1 << a.lgs) < lg) ++a.lgs;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel<T>), dim3(grid),
                                  dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole solve on `stream`, one cooperative launch; returns the CUDA
// error of the launch as an int (0 when accepted).  state (t_tiles,
// s_count * ntp, 128) and cen (s_count,) hold the initial values and
// receive the solution (updated in place); old is scratch of the
// state's size, src scratch of (t_tiles, s_count, ntp + 4, 128); ring_w
// and fan_w (t_tiles, 128), pdn and pup (7, t_tiles * 128); the chunk
// tables of fused_circulant.relax_chunks: ck_info (n_chunks, 2), ck_row
// (n_chunks, 32), ck_idx and ck_w (n_chunks, 32, 32); flags (2,) int32
// zeroed; iters () int32 receives the iteration count.  Values are
// float32 (is_double == 0) or float64, non-negative or +inf; all
// contiguous device memory of the current device.
extern "C" int fused_launch(void* state, void* cen, void* old, void* src,
                            const void* ring_w, const void* pdn, const void* pup,
                            const void* fan_w, const void* ck_info, const void* ck_row,
                            const void* ck_idx, const void* ck_w, void* flags,
                            void* iters, int t_tiles, int nt, int ntp, int s_count,
                            int n_chunks, int max_iters, int is_double, void* stream) {
  // ck_info packs t * kSlabs + slab and the source tile in 16 bits each
  if (t_tiles < 1 || t_tiles * lane_gather::kSlabs > 0xffff || s_count < 1 || nt < 3 || nt > ntp ||
      ntp % 8 != 0 || n_chunks < 0 || max_iters < 0 ||
      static_cast<long long>(t_tiles) * s_count * (ntp + 2 * kHalo) * kLanes > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    FusedArgs<double> a{static_cast<double*>(state), static_cast<double*>(cen),
                        static_cast<double*>(old), static_cast<double*>(src),
                        static_cast<const double*>(ring_w), static_cast<const double*>(pdn),
                        static_cast<const double*>(pup), static_cast<const double*>(fan_w),
                        static_cast<const int*>(ck_info), static_cast<const int*>(ck_row),
                        static_cast<const int*>(ck_idx), static_cast<const double*>(ck_w),
                        static_cast<int*>(flags), static_cast<int*>(iters),
                        t_tiles, nt, ntp, s_count, n_chunks, max_iters, 0};
    return run<double>(a, st);
  }
  FusedArgs<float> a{static_cast<float*>(state), static_cast<float*>(cen),
                     static_cast<float*>(old), static_cast<float*>(src),
                     static_cast<const float*>(ring_w), static_cast<const float*>(pdn),
                     static_cast<const float*>(pup), static_cast<const float*>(fan_w),
                     static_cast<const int*>(ck_info), static_cast<const int*>(ck_row),
                     static_cast<const int*>(ck_idx), static_cast<const float*>(ck_w),
                     static_cast<int*>(flags), static_cast<int*>(iters),
                     t_tiles, nt, ntp, s_count, n_chunks, max_iters, 0};
  return run<float>(a, st);
}
