// The locator's grid search: for every event row e, the node j with the
// least weighted misfit once the origin time is eliminated, its origin
// time t0 and its misfit m.
//
// A kernel of the port's own choice: the JAX package runs this search as
// one jitted XLA function per event (raytracer_tpu/solvers/locate.py
// _grid_search_jit:95, the "direct" mode here) or per block of 64 events
// (_grid_search_catalogue_jit:66, the "expanded" mode), with no Pallas
// kernel.  Python wrapper and plain PyTorch twin:
// raytracer_tpu_torch/ops/gridsearch.py (grid_search,
// grid_search_reference, grid_search_catalogue_reference).
//
// What it computes.  T (K, n) station fields, t_obs (E, K) picks, w2 (K)
// squared weights, W2 = sum(w2) (summed in k order by the kernel).  A
// column j with any non-finite T[k, j] gets m = inf (S in the liquid
// core).
//   direct:   resid_k = t_obs[e, k] - T[k, j],
//             t0 = (sum_k w2_k resid_k) / W2,
//             m  = sum_k w2_k (resid_k - t0)^2.
//   expanded: the twin's event side, formed by the kernel: s1 = sum_k
//             w2_k t_obs[e, k], Oc = t_obs - s1 / W2, a = w2 Oc, A =
//             sum_k a_k Oc_k.  Per column, the twin's demeaning: Tm = T
//             (0 in a non-finite column), s2 = sum_k w2_k Tm_k, Tc_k =
//             Tm_k - s2 / W2, C = sum_k w2_k Tc_k^2; then B = sum_k a[e,
//             k] Tc_k, m = (A_e - 2 B) + C and t0 = (s1_e - s2_j) / W2.
// j is the first index among equal minima (a NaN misfit counts as the
// least, as torch.argmin and jnp.argmin take it), so a row whose columns
// are all inf gives j = 0.  The sums run in another order than the
// twin's matmuls, so m and t0 agree with it to rounding, not bit for bit:
// tests and chip_smoke.py hold them to the tie rule of
// raytracer_tpu_torch/ops/gridsearch_check.py (a tolerance relative to m
// in the direct mode, to the size of its terms A_e + C_j in the expanded
// one), and compare node ids only where the twin's best misfit beats its
// second best by more than that.
//
// Design.  Pass 1: a block of 8 warps walks column tiles of 128 columns
// (grid-stride over as many blocks as are resident at once, tiles in
// ascending order).  Where K fits one chunk of 16 (the location path's
// 12 stations), the tile's times come into shared memory by cp.async
// while the block searches the tile before it, and the block's event
// chunk (64 events expanded, 32 direct: a, or t_obs, with w2) stays there
// for all its tiles; for a larger K, chunk by chunk.  Per tile, 128
// threads find their column's finiteness and, in the expanded formula,
// demean it (s2, the mean, C).  Lane l of warp w owns the tile's
// columns l, l + 32, l + 64, l + 96 and the warp's events (8 expanded,
// 4 direct): a register tile of sums (B; or s, then t0 = s / W2 and m
// in a second walk over K) fed by broadcast reads of the event side and
// conflict-free reads of the times.  Each lane keeps, for each of its
// events, its best (m, j) over all its columns: it visits them in
// ascending order, so a later column replaces the best only by coming
// before it (a lesser m, or a NaN), and ties keep the first index with
// no reduction a column.  Once the block's tiles are done, each warp
// reduces its events across its lanes (shuffles) and writes one (m, j)
// partial per (event, block): each event of a chunk belongs to one
// warp, so no cross-warp step.  Pass 2, a second small launch: one warp
// an event reduces the partials (the pair order (m, j) is total, so the
// result does not depend on the reduction's order or the grid) and
// recomputes t0 at the chosen column.  No atomics: the result is the
// same every run.  The first design (a thread a column, a warp and then
// a block reduction for every event) spent ~50 reduction instructions
// per event and 32 columns against ~12 multiply-adds: 0.140 ms.
//
// What bounds it on an H100.  The fields are read once: K n itemsize
// bytes (14.4 MB at K = 12, n = 150,121 in float64, 4.3 us at 3.35 TB/s).
// The fewest operations that give (j, t0, m), in either mode, are the
// expanded mode's: the (E, K) @ (K, n) product, E n 2K (0.23 G at E = 64,
// 3.4 us at the float64 tensor cores' 67 TFLOP/s), then the combine, E n
// 3, and the demeaning, n (6K + 2) (0.04 G, 1.2 us at 34 TFLOP/s): 4.6 us
// in float64, so the bound is the operations, just above the read.  This
// kernel runs the product on the FP64 multiply-add pipes (34 TFLOP/s:
// 6.8 us), not the tensor cores' DMMA; in float32 the products are IEEE
// fused multiply-adds, no TF32 (the tie rule's ulp tolerances assume
// them).  The per-(event, block) reductions come on top.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 4;             // columns a lane owns in a tile, 32 apart
constexpr int kTile = 32 * kCT;    // columns a tile
constexpr int kKC = 16;            // station times a chunk of K in shared memory
constexpr int kNoCol = 0x7fffffff;

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double inf_of<double>() { return CUDART_INF; }

// (m1, j1) before (m2, j2): the lesser misfit, NaN the least, then the
// lower column.
template <typename T>
__device__ __forceinline__ bool before(T m1, int j1, T m2, int j2) {
  const bool n1 = isnan(m1), n2 = isnan(m2);
  if (n1 != n2) return n1;
  if (n1 || m1 == m2) return j1 < j2;
  return m1 < m2;
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& m, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T mo = __shfl_down_sync(0xffffffffu, m, off);
    const int jo = __shfl_down_sync(0xffffffffu, j, off);
    if (before(mo, jo, m, j)) {
      m = mo;
      j = jo;
    }
  }
}

// a lane's running best over its columns, which it visits in ascending
// order: (m, c) replaces (bm, bj) iff it comes before it, that is iff m
// is less or m is NaN, and bm is no NaN (c > bj: a tie keeps bj)
template <typename T>
__device__ __forceinline__ void keep_first(T m, int c, T& bm, int& bj) {
  if (!(m >= bm) && bm == bm) {
    bm = m;
    bj = c;
  }
}

// the warp's N events of one k from shared memory, 16 bytes a load (a
// broadcast: every lane reads the same words)
template <int N>
__device__ __forceinline__ void load_events(const double* p, double (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_events(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
    o[i + 2] = v.z;
    o[i + 3] = v.w;
  }
}

// W2 = sum_k w2_k, in k order
template <typename T>
__device__ __forceinline__ T weight_sum(const T* __restrict__ w2, int K) {
  T W2 = T(0);
  for (int k = 0; k < K; ++k) W2 += __ldg(w2 + k);
  return W2;
}

// the event side of the expanded formula, as the wrapper's twin takes
// it: s1 = sum_k w2_k t_k, Oc_k = t_k - s1 / W2, a_k = w2_k Oc_k, A =
// sum_k a_k Oc_k; returns s1 / W2 and sets A
template <typename T>
__device__ __forceinline__ T event_mean(const T* __restrict__ row, const T* __restrict__ w2,
                                        int K, T W2, T& A) {
  T s1 = T(0);
  for (int k = 0; k < K; ++k) s1 = fma(__ldg(w2 + k), __ldg(row + k), s1);
  const T mean = s1 / W2;
  A = T(0);
  for (int k = 0; k < K; ++k) {
    const T oc = __ldg(row + k) - mean;
    A = fma(__ldg(w2 + k) * oc, oc, A);
  }
  return mean;
}

struct Args {
  const void* T;     // (K, n)
  const void* obs;   // t_obs (E, K)
  const void* w2;    // (K)
  int K, n, E;
};

// Pass 1 (see the head of this file).  A block walks column tiles of
// kTile columns (grid-stride, ascending); in a tile lane l of every warp
// owns columns l, l + 32, l + 64, l + 96, and warp w the events [e0 + w
// kEPT, e0 + w kEPT + kEPT) of the block's event chunk.  Shared memory
// holds the tile's times (a chunk of K of them; where K fits one chunk,
// two tiles' worth, the next one's copied in by cp.async while this one
// is searched) and the chunk's event side.  Each lane keeps its running
// best (m, j) of its kEPT events over all its columns; once the block's
// tiles are done, a warp reduces its events across its lanes and writes
// one partial per (event, block).
template <typename T, bool kExpanded>
__global__ void __launch_bounds__(kThreads, 2)
    search_kernel(Args args, T* __restrict__ pm, int* __restrict__ pj) {
  // events a warp takes at once (its register tile is kEPT x kCT): the
  // expanded formula keeps one sum a pair, the direct one two
  constexpr int kEPT = kExpanded ? 8 : 4;
  constexpr int kEC = kWarps * kEPT;  // events a chunk
  const T* __restrict__ Tf = static_cast<const T*>(args.T);
  const T* __restrict__ obs = static_cast<const T*>(args.obs);
  const T* __restrict__ w2 = static_cast<const T*>(args.w2);
  const int K = args.K, n = args.n, E = args.E;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T W2 = weight_sum(w2, K);
  const int tiles = (n + kTile - 1) / kTile;
  const int kchunks = (K + kKC - 1) / kKC;
  const bool one = kchunks == 1;  // the whole of K in one chunk
  __shared__ T tile_s[2][kKC][kTile];  // the tile's times (expanded: demeaned)
  // the chunk's event side (a, or t_obs), a warp's events side by side
  __shared__ __align__(16) T obs_s[kKC][kEC];
  __shared__ T w2_s[kKC];
  __shared__ T mean_s[kTile], C_s[kTile];
  __shared__ int fin_s[kTile];
  __shared__ T A_s[kEC], emean_s[kEC];

  // the event side of chunk kc of K for the events from e0
  const auto stage_events = [&](int e0, int kc) {
    const int k0 = kc * kKC, kn = min(kKC, K - k0);
    for (int q = threadIdx.x; q < kEC * kKC; q += kThreads) {
      const int kk = q / kEC, ee = q % kEC;
      T v = T(0);
      if (kk < kn && e0 + ee < E) {
        v = __ldg(obs + static_cast<int64_t>(e0 + ee) * K + k0 + kk);
        if constexpr (kExpanded) v = __ldg(w2 + k0 + kk) * (v - emean_s[ee]);
      }
      obs_s[kk][ee] = v;
    }
    if (threadIdx.x < kKC) w2_s[threadIdx.x] = threadIdx.x < kn ? __ldg(w2 + k0 + threadIdx.x) : T(0);
  };
  // the tile's times of chunk kc into buffer b: cp.async for the columns
  // below n (waited by the caller), 0 past it
  const auto stage_tile = [&](int c0, int kc, int b) {
    const int k0 = kc * kKC, kn = min(kKC, K - k0);
    for (int q = threadIdx.x; q < kKC * kTile; q += kThreads) {
      const int kk = q / kTile, cc = q % kTile, c = c0 + cc;
      if (kk < kn && c < n)
        cp_async_ca<sizeof(T)>(&tile_s[b][kk][cc], Tf + static_cast<int64_t>(k0 + kk) * n + c);
      else
        tile_s[b][kk][cc] = T(0);
    }
    cp_async_commit();
  };
  // the tile's columns from buffer b (one chunk) or from device memory:
  // finite (the twin's all(isfinite)) and, in the expanded formula, the
  // twin's demeaning (s2, the mean, C), the buffer's times demeaned in
  // place
  const auto prepare = [&](int c0, int b) {
    if (threadIdx.x >= kTile) return;
    const int cc = threadIdx.x, c = c0 + cc;
    bool fin = c < n;
    T s2 = T(0), mean = T(0), C = T(0);
    if (one) {  // the times and the weights in shared memory
#pragma unroll
      for (int k = 0; k < kKC; ++k)
        if (k < K) {
          const T v = tile_s[b][k][cc];
          fin &= isfinite(v);
          if constexpr (kExpanded) s2 = fma(w2_s[k], v, s2);
        }
      if constexpr (kExpanded) {
        if (fin) mean = s2 / W2;
#pragma unroll
        for (int k = 0; k < kKC; ++k)
          if (k < K) {
            const T tc = fin ? tile_s[b][k][cc] - mean : T(0);
            C = fma(w2_s[k], tc * tc, C);
            tile_s[b][k][cc] = tc;
          }
      }
    } else {
      for (int k = 0; k < K && fin; ++k) {
        const T v = __ldg(Tf + static_cast<int64_t>(k) * n + c);
        fin &= isfinite(v);
        if constexpr (kExpanded) s2 = fma(__ldg(w2 + k), v, s2);
      }
      if (kExpanded && fin) {
        mean = s2 / W2;
        for (int k = 0; k < K; ++k) {
          const T tc = __ldg(Tf + static_cast<int64_t>(k) * n + c) - mean;
          C = fma(__ldg(w2 + k), tc * tc, C);
        }
      }
    }
    fin_s[cc] = fin;
    mean_s[cc] = mean;
    C_s[cc] = C;
  };
  // one chunk of K of the warp's register tile from buffer b
  const auto accumulate = [&](T (&acc)[kEPT][kCT], T (&msum)[kEPT][kCT], int kn, int b,
                              int walk) {
    for (int kk = 0; kk < kn; ++kk) {
      T o[kEPT], t[kCT];
      load_events(&obs_s[kk][warp * kEPT], o);
#pragma unroll
      for (int j = 0; j < kCT; ++j) t[j] = tile_s[b][kk][lane + 32 * j];
      if constexpr (kExpanded) {
#pragma unroll
        for (int i = 0; i < kEPT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) acc[i][j] = fma(o[i], t[j], acc[i][j]);
      } else {
        const T wk = w2_s[kk];
#pragma unroll
        for (int i = 0; i < kEPT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            if (walk == 0) {
              acc[i][j] = fma(wk, o[i] - t[j], acc[i][j]);
            } else {
              const T d = (o[i] - t[j]) - acc[i][j];
              msum[i][j] = fma(wk, d * d, msum[i][j]);
            }
          }
      }
    }
  };

  for (int e0 = 0; e0 < E; e0 += kEC) {
    const int ew = e0 + warp * kEPT;  // the warp's first event
    const bool busy = ew < E;
    // the lane's first column with +inf: any first candidate keeps its
    // column, a later one replaces it only by coming before it
    const int cfirst = blockIdx.x * kTile + lane;
    T bm[kEPT];
    int bj[kEPT];
#pragma unroll
    for (int i = 0; i < kEPT; ++i) {
      bm[i] = inf_of<T>();
      bj[i] = cfirst < n ? cfirst : kNoCol;
    }
    __syncthreads();  // the last chunk's readers of the event side are done
    if (kExpanded && threadIdx.x < kEC) {
      const int e = e0 + threadIdx.x;
      T A = T(0), mean = T(0);
      if (e < E) mean = event_mean(obs + static_cast<int64_t>(e) * K, w2, K, W2, A);
      A_s[threadIdx.x] = A;
      emean_s[threadIdx.x] = mean;
    }
    if (one) {
      __syncthreads();
      stage_events(e0, 0);
      if (blockIdx.x < tiles) stage_tile(blockIdx.x * kTile, 0, 0);
    }
    int q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++q) {
      const int c0 = tile * kTile, b = q & 1;
      T acc[kEPT][kCT], msum[kEPT][kCT];
#pragma unroll
      for (int i = 0; i < kEPT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) acc[i][j] = msum[i][j] = T(0);
      if (one) {
        cp_async_wait_all();
        __syncthreads();  // the tile's times are in; the last tile's readers done
        prepare(c0, b);
        __syncthreads();
        if (tile + gridDim.x < tiles) stage_tile(c0 + gridDim.x * kTile, 0, b ^ 1);
        if (busy)
          for (int walk = 0; walk < (kExpanded ? 1 : 2); ++walk) {
            accumulate(acc, msum, K, b, walk);
            if (!kExpanded && walk == 0)
#pragma unroll
              for (int i = 0; i < kEPT; ++i)
#pragma unroll
                for (int j = 0; j < kCT; ++j) acc[i][j] = acc[i][j] / W2;  // t0
          }
      } else {
        __syncthreads();  // the last tile's readers are done
        prepare(c0, 0);
        for (int walk = 0; walk < (kExpanded ? 1 : 2); ++walk) {
          for (int kc = 0; kc < kchunks; ++kc) {
            __syncthreads();  // the demeaning, or the last chunk's readers
            stage_events(e0, kc);
            stage_tile(c0, kc, 0);
            cp_async_wait_all();
            if constexpr (kExpanded) {  // the chunk's times demeaned
              for (int qq = threadIdx.x; qq < kKC * kTile; qq += kThreads) {
                const int kk = qq / kTile, cc = qq % kTile;
                tile_s[0][kk][cc] = fin_s[cc] ? tile_s[0][kk][cc] - mean_s[cc] : T(0);
              }
            }
            __syncthreads();
            if (busy) accumulate(acc, msum, min(kKC, K - kc * kKC), 0, walk);
          }
          if (!kExpanded && walk == 0)
#pragma unroll
            for (int i = 0; i < kEPT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[i][j] = acc[i][j] / W2;  // t0
        }
      }
      if (!busy) continue;
      // the lane's columns in ascending order into its running bests:
      // expanded m = (A_e - 2 B) + C, direct the second walk's sum
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int cc = lane + 32 * j, c = c0 + cc;
        if (c < n) {
          const bool fin = fin_s[cc];
          const T Cc = C_s[cc];
#pragma unroll
          for (int i = 0; i < kEPT; ++i) {
            const T m = kExpanded ? (A_s[warp * kEPT + i] - T(2) * acc[i][j]) + Cc : msum[i][j];
            keep_first(fin ? m : inf_of<T>(), c, bm[i], bj[i]);
          }
        }
      }
    }
    // one partial per (event, block): the warp's lanes reduced
#pragma unroll
    for (int i = 0; i < kEPT; ++i) {
      T mm = bm[i];
      int j = bj[i];
      warp_argmin(mm, j);
      const int e = ew + i;
      if (lane == 0 && e < E) {
        const int64_t at = static_cast<int64_t>(e) * gridDim.x + blockIdx.x;
        pm[at] = mm;
        pj[at] = j;
      }
    }
  }
}

// One warp an event: the least (m, j) over the blocks' partials, then t0
// at that column.
template <typename T, bool kExpanded>
__global__ void __launch_bounds__(128)
    finish_kernel(Args args, const T* __restrict__ pm, const int* __restrict__ pj, int nblocks,
                  int64_t* __restrict__ j_out, T* __restrict__ t0_out, T* __restrict__ m_out) {
  const int e = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= args.E) return;
  T m = inf_of<T>();
  int j = kNoCol;
  for (int b = lane; b < nblocks; b += 32) {
    const int64_t at = static_cast<int64_t>(e) * nblocks + b;
    if (before(pm[at], pj[at], m, j)) {
      m = pm[at];
      j = pj[at];
    }
  }
  warp_argmin(m, j);
  if (lane != 0) return;
  const T* __restrict__ Tf = static_cast<const T*>(args.T);
  const T* __restrict__ w2 = static_cast<const T*>(args.w2);
  const T* __restrict__ row = static_cast<const T*>(args.obs) + static_cast<int64_t>(e) * args.K;
  const T W2 = weight_sum(w2, args.K);
  const int K = args.K, n = args.n;
  T t0;
  if (kExpanded) {  // t0 = (s1 - s2_j) / W2, s2 of the twin's Tm
    bool finite = true;
    for (int k = 0; k < K; ++k) finite &= isfinite(Tf[static_cast<int64_t>(k) * n + j]);
    T s1 = T(0), s2 = T(0);
    for (int k = 0; k < K; ++k) {
      s1 = fma(w2[k], row[k], s1);
      if (finite) s2 = fma(w2[k], Tf[static_cast<int64_t>(k) * n + j], s2);
    }
    t0 = (s1 - s2) / W2;
  } else {
    T s = T(0);
    for (int k = 0; k < K; ++k) s = fma(w2[k], row[k] - Tf[static_cast<int64_t>(k) * n + j], s);
    t0 = s / W2;
  }
  j_out[e] = j;
  t0_out[e] = t0;
  m_out[e] = m;
}

// The blocks of pass 1 for n columns: one a column tile, at most as many
// as are resident at once (the rest walk more tiles), or the negated
// CUDA error.
template <typename T, bool kExpanded>
int blocks_for(int n) {
  static int cap = 0;  // the device's resident blocks, asked once
  if (!cap) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, search_kernel<T, kExpanded>,
                                                        kThreads, 0);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    cap = per_sm * sms;
  }
  const int tiles = (n + kTile - 1) / kTile;
  return tiles < cap ? tiles : cap;
}

template <typename T, bool kExpanded>
int launch(const Args& args, int nblocks, void* pm, void* pj, void* j_out, void* t0_out,
           void* m_out, cudaStream_t st) {
  search_kernel<T, kExpanded><<<nblocks, kThreads, 0, st>>>(args, static_cast<T*>(pm),
                                                            static_cast<int*>(pj));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<T, kExpanded><<<(args.E + 3) / 4, 128, 0, st>>>(
      args, static_cast<const T*>(pm), static_cast<const int*>(pj), nblocks,
      static_cast<int64_t*>(j_out), static_cast<T*>(t0_out), static_cast<T*>(m_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of column blocks of pass 1 for n columns in the given
// formula and type (is_double), or the negated CUDA error: the caller
// allocates the partials pm (E * blocks, the fields' type) and pj (E *
// blocks, int32) and passes the same number to gridsearch_launch.
extern "C" int gridsearch_blocks(int n, int expanded, int is_double) {
  if (n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  if (is_double) return expanded ? blocks_for<double, true>(n) : blocks_for<double, false>(n);
  return expanded ? blocks_for<float, true>(n) : blocks_for<float, false>(n);
}

// Launches both passes on `stream`; returns the CUDA error as an int (0
// when both launches were accepted).  T (K, n), t_obs (E, K) and w2 (K)
// of one type, float32 or float64 (is_double); the kernel forms W2 and,
// in the expanded formula, the event side (s1, a, A) itself.  nblocks
// from gridsearch_blocks, pm and pj the partials it sizes.  Outputs j (E)
// int64, t0 (E) and m (E).  All contiguous device memory.
extern "C" int gridsearch_launch(const void* T, int K, int n, const void* t_obs, int E,
                                 const void* w2, int expanded, int nblocks, void* pm, void* pj,
                                 void* j_out, void* t0_out, void* m_out, int is_double,
                                 void* stream) {
  if (K < 1 || n < 1 || E < 0 || nblocks < 1 || nblocks > (n + kTile - 1) / kTile || !T ||
      !t_obs || !w2 || !pm || !pj || !j_out || !t0_out || !m_out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const Args args{T, t_obs, w2, K, n, E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return expanded ? launch<double, true>(args, nblocks, pm, pj, j_out, t0_out, m_out, st)
                    : launch<double, false>(args, nblocks, pm, pj, j_out, t0_out, m_out, st);
  return expanded ? launch<float, true>(args, nblocks, pm, pj, j_out, t0_out, m_out, st)
                  : launch<float, false>(args, nblocks, pm, pj, j_out, t0_out, m_out, st);
}
