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
// What it computes.  T (K, n) station fields, w2 (K) squared weights,
// W2 = sum(w2) (one value on the device, the twin's torch sum).  A column
// j with any non-finite T[k, j] gets m = inf (S in the liquid core).
//   direct:   obs = t_obs (E, K).  resid_k = t_obs[e, k] - T[k, j],
//             t0 = (sum_k w2_k resid_k) / W2,
//             m  = sum_k w2_k (resid_k - t0)^2.
//   expanded: obs = a (E, K), A (E) and s1 (E), made by the wrapper with
//             the twin's own torch ops: s1 = T_obs @ w2, Oc = T_obs -
//             s1 / W2, a = w2 * Oc, A = sum_k a * Oc.  Per column, the
//             twin's demeaning: Tm = T (0 in a non-finite column), s2 =
//             sum_k w2_k Tm_k, Tc_k = Tm_k - s2 / W2, C = sum_k w2_k Tc_k^2;
//             then B = sum_k a[e, k] Tc_k, m = (A_e - 2 B) + C and
//             t0 = (s1_e - s2_j) / W2.
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
// Design.  Pass 1: a thread owns a column and keeps its first kRegK
// times (or demeaned times) in registers, reading the rest of K from
// device memory (L1/L2) when K is larger; it walks the events in chunks
// of kEvChunk, each event's misfit reduced by warp shuffles and then
// across the block's warps through shared memory into one (m, j) partial
// per (event, block).  Pass 2, a second small launch: one warp an event
// reduces the partials (the pair order (m, j) is total, so the result
// does not depend on the reduction's order) and recomputes t0 at the
// chosen column.  No atomics: the result is the same every run.
//
// What bounds it on an H100.  The fields are read once: K n itemsize
// bytes (14.4 MB at K = 12, n = 150,121 in float64, 4.3 us at 3.35 TB/s).
// The fewest operations that give (j, t0, m), in either mode, are the
// expanded mode's: the (E, K) @ (K, n) product, E n 2K (0.23 G at E = 64,
// 3.4 us at the float64 tensor cores' 67 TFLOP/s), then the combine, E n
// 3, and the demeaning, n (6K + 2) (0.04 G, 1.2 us at 34 TFLOP/s): 4.6 us
// in float64, so the bound is the operations, just above the read.  The
// per-block reductions (E of them a block) come on top.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegK = 16;      // station times a thread keeps in registers
constexpr int kEvChunk = 32;   // events a block reduces between barriers
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

struct Args {
  const void* T;     // (K, n)
  const void* obs;   // direct: t_obs (E, K); expanded: a (E, K)
  const void* w2;    // (K)
  const void* W2;    // (1)
  const void* A;     // expanded: (E)
  const void* s1;    // expanded: (E)
  int K, n, E;
};

template <typename T, bool kExpanded>
__global__ void __launch_bounds__(kThreads)
    search_kernel(Args args, T* __restrict__ pm, int* __restrict__ pj) {
  const T* __restrict__ Tf = static_cast<const T*>(args.T);
  const T* __restrict__ obs = static_cast<const T*>(args.obs);
  const T* __restrict__ w2 = static_cast<const T*>(args.w2);
  const T* __restrict__ Ae = static_cast<const T*>(args.A);
  const int K = args.K, n = args.n, E = args.E;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const bool live = col < n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T W2 = *static_cast<const T*>(args.W2);
  __shared__ T sm[kWarps][kEvChunk];
  __shared__ int sj[kWarps][kEvChunk];

  // the column's times; `finite` is the twin's all(isfinite) mask
  T reg[kRegK];
  bool finite = live;
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    reg[k] = T(0);
    if (k < K && live) {
      reg[k] = Tf[static_cast<int64_t>(k) * n + col];
      finite &= isfinite(reg[k]);
    }
  }
  for (int k = kRegK; k < K && live; ++k)
    finite &= isfinite(Tf[static_cast<int64_t>(k) * n + col]);

  // expanded: demean the column as the twin does (Tm, s2, Tc, C)
  T mean = T(0), C = T(0);
  if (kExpanded && finite) {
    T s2 = T(0);
#pragma unroll
    for (int k = 0; k < kRegK; ++k)
      if (k < K) s2 += w2[k] * reg[k];
    for (int k = kRegK; k < K; ++k) s2 += w2[k] * Tf[static_cast<int64_t>(k) * n + col];
    mean = s2 / W2;
#pragma unroll
    for (int k = 0; k < kRegK; ++k)
      if (k < K) {
        reg[k] = reg[k] - mean;
        C += w2[k] * (reg[k] * reg[k]);
      }
    for (int k = kRegK; k < K; ++k) {
      const T tc = Tf[static_cast<int64_t>(k) * n + col] - mean;
      C += w2[k] * (tc * tc);
    }
  }

  for (int e0 = 0; e0 < E; e0 += kEvChunk) {
    const int ec = min(kEvChunk, E - e0);
    for (int i = 0; i < ec; ++i) {
      const int e = e0 + i;
      const T* __restrict__ row = obs + static_cast<int64_t>(e) * K;
      T m = inf_of<T>();
      if (finite) {
        if (kExpanded) {
          T B = T(0);
#pragma unroll
          for (int k = 0; k < kRegK; ++k)
            if (k < K) B += row[k] * reg[k];
          for (int k = kRegK; k < K; ++k)
            B += row[k] * (Tf[static_cast<int64_t>(k) * n + col] - mean);
          m = (Ae[e] - T(2) * B) + C;
        } else {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < kRegK; ++k)
            if (k < K) s += w2[k] * (row[k] - reg[k]);
          for (int k = kRegK; k < K; ++k)
            s += w2[k] * (row[k] - Tf[static_cast<int64_t>(k) * n + col]);
          const T t0 = s / W2;
          m = T(0);
#pragma unroll
          for (int k = 0; k < kRegK; ++k)
            if (k < K) {
              const T d = (row[k] - reg[k]) - t0;
              m += w2[k] * (d * d);
            }
          for (int k = kRegK; k < K; ++k) {
            const T d = (row[k] - Tf[static_cast<int64_t>(k) * n + col]) - t0;
            m += w2[k] * (d * d);
          }
        }
      }
      int j = live ? col : kNoCol;
      warp_argmin(m, j);
      if (lane == 0) {
        sm[warp][i] = m;
        sj[warp][i] = j;
      }
    }
    __syncthreads();
    if (threadIdx.x < ec) {
      T m = sm[0][threadIdx.x];
      int j = sj[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (before(sm[w][threadIdx.x], sj[w][threadIdx.x], m, j)) {
          m = sm[w][threadIdx.x];
          j = sj[w][threadIdx.x];
        }
      const int64_t at = static_cast<int64_t>(e0 + threadIdx.x) * gridDim.x + blockIdx.x;
      pm[at] = m;
      pj[at] = j;
    }
    __syncthreads();
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
  const T W2 = *static_cast<const T*>(args.W2);
  const int K = args.K, n = args.n;
  T t0;
  if (kExpanded) {
    bool finite = true;
    for (int k = 0; k < K; ++k) finite &= isfinite(Tf[static_cast<int64_t>(k) * n + j]);
    T s2 = T(0);
    if (finite)
      for (int k = 0; k < K; ++k) s2 += w2[k] * Tf[static_cast<int64_t>(k) * n + j];
    t0 = (static_cast<const T*>(args.s1)[e] - s2) / W2;
  } else {
    const T* __restrict__ row = static_cast<const T*>(args.obs) + static_cast<int64_t>(e) * K;
    T s = T(0);
    for (int k = 0; k < K; ++k) s += w2[k] * (row[k] - Tf[static_cast<int64_t>(k) * n + j]);
    t0 = s / W2;
  }
  j_out[e] = j;
  t0_out[e] = t0;
  m_out[e] = m;
}

template <typename T, bool kExpanded>
int launch(const Args& args, void* pm, void* pj, void* j_out, void* t0_out, void* m_out,
           cudaStream_t st) {
  const int nblocks = (args.n + kThreads - 1) / kThreads;
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

// The number of column blocks of pass 1 for n columns: the caller
// allocates the partials pm (E * blocks, the fields' type) and pj
// (E * blocks, int32).
extern "C" int gridsearch_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Launches both passes on `stream`; returns the CUDA error as an int (0
// when both launches were accepted).  T (K, n), obs (E, K), w2 (K) and W2
// (1) of one type, float32 or float64 (is_double); expanded: A (E) and
// s1 (E) of that type too (else ignored).  Outputs j (E) int64, t0 (E)
// and m (E).  All contiguous device memory.
extern "C" int gridsearch_launch(const void* T, int K, int n, const void* obs, int E,
                                 const void* w2, const void* W2, const void* A, const void* s1,
                                 int expanded, void* pm, void* pj, void* j_out, void* t0_out,
                                 void* m_out, int is_double, void* stream) {
  if (K < 1 || n < 1 || E < 0 || !T || !obs || !w2 || !W2 || !pm || !pj || !j_out || !t0_out ||
      !m_out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (expanded && (!A || !s1)) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const Args args{T, obs, w2, W2, A, s1, K, n, E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return expanded ? launch<double, true>(args, pm, pj, j_out, t0_out, m_out, st)
                    : launch<double, false>(args, pm, pj, j_out, t0_out, m_out, st);
  return expanded ? launch<float, true>(args, pm, pj, j_out, t0_out, m_out, st)
                  : launch<float, false>(args, pm, pj, j_out, t0_out, m_out, st);
}
