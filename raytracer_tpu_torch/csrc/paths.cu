// Predecessor walks and their sensitivity rows, one thread a receiver.
//
// A kernel of the port's own choice: the JAX package runs this walk as
// XLA, a fixed-depth lax.scan vmapped over the receivers
// (raytracer_tpu/solvers/path.py backtrace_paths) followed by the pair
// terms and scatter of raytracer_tpu/solvers/sensitivity.py _coo_jit /
// _dense_jit, with no Pallas kernel.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/paths.py (paths, paths_reference).
//
// What it computes.  prev (n) int32, receivers (n_rec) int32.  Thread r
// walks node = receivers[r] for max_len steps, writing nodes[r, k] =
// node and then moving to prev[node] unless node == source (so the row
// ends in the source, repeated).  With coords (ndim, n), U (n) of type T
// (float or double, one template build a type) and partners (n, P)
// int32, each walked pair (a, b) = (nodes[r, k], nodes[r, k+1]) also
// gives
//   L = sqrt(sum_ax (x_a - x_b)^2),  usum = U_a + U_b,
//   inv = 1/usum unless usum <= 0 or b is one of a's twin partners
//         (a zero-cost halo merge hop), else 0,
//   t_e = (2 L) inv,  g = -(t_e inv),
// written as ids[r, k] = a, ids[r, K + k] = b, vals[r, k] = vals[r, K +
// k] = g (K = max_len - 1).  With dense (n_rec, n) zeroed by the caller,
// the thread then adds vals[r, j] at column ids[r, j] for j = 0 .. 2K-1
// in order, the twin's scatter_add_ order: no other thread touches row r,
// so there are no atomics and the floats are the same every run.  Every
// product, sum and difference is one correctly rounded operation
// (__fmul_rn and the like, no contraction into FMAs), sqrt and the
// division are IEEE, so ids are the twin's bit for bit and vals too.
//
// What bounds it on an H100.  The walk is a chain of dependent gathers,
// one a step: at 180x63 with 150 receivers and max_len 972 that is 972
// device-memory latencies (~0.5-1 us each from L2) on 150 threads, so the
// launch is latency-bound and the card is nearly empty; the bytes (the
// nodes, ids and vals written, the walked prev, coords and U entries
// read) take microseconds.  The simple design stands: one thread a
// receiver, no shared memory.  A faster one would walk several receivers'
// chains per warp with their loads in flight together (they are already
// independent across threads) or shorten the chains by pointer jumping.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::mul_rn;
using minplus::sub_rn;

constexpr int kThreads = 128;

template <typename T>
struct Terms {
  const T* coords;     // (ndim, n)
  const T* U;          // (n)
  const int* partners; // (n, P)
  int ndim;
  int P;
};

template <typename T>
__device__ __forceinline__ T pair_g(const Terms<T>& tm, int n, int a, int b) {
  T L2 = T(0);
  for (int ax = 0; ax < tm.ndim; ++ax) {
    const T d = sub_rn(tm.coords[static_cast<int64_t>(ax) * n + a],
                       tm.coords[static_cast<int64_t>(ax) * n + b]);
    L2 = ax == 0 ? mul_rn(d, d) : add_rn(L2, mul_rn(d, d));
  }
  const T L = sqrt(L2);
  const T usum = add_rn(tm.U[a], tm.U[b]);
  bool twin = false;
  for (int p = 0; p < tm.P; ++p) twin |= tm.partners[static_cast<int64_t>(a) * tm.P + p] == b;
  const T inv = (usum > T(0) && !twin) ? T(1) / usum : T(0);
  const T te = mul_rn(mul_rn(T(2), L), inv);
  return -mul_rn(te, inv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paths_kernel(const int* __restrict__ prev, int source, const int* __restrict__ receivers,
                 int n_rec, int max_len, int n, int* __restrict__ nodes, Terms<T> tm,
                 int* __restrict__ ids, T* __restrict__ vals, T* __restrict__ dense) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rec) return;
  const int K = max_len - 1;
  int* nrow = nodes + static_cast<int64_t>(r) * max_len;
  int* irow = ids ? ids + static_cast<int64_t>(r) * 2 * K : nullptr;
  T* vrow = vals ? vals + static_cast<int64_t>(r) * 2 * K : nullptr;
  int a = receivers[r];
  nrow[0] = a;
  for (int k = 0; k < K; ++k) {
    int b = a;
    if (a != source) {
      const int p = prev[a];
      b = (p >= 0 && p < n) ? p : a;
    }
    nrow[k + 1] = b;
    if (irow) {
      const T g = pair_g(tm, n, a, b);
      irow[k] = a;
      irow[K + k] = b;
      vrow[k] = g;
      vrow[K + k] = g;
    }
    a = b;
  }
  if (dense) {
    T* drow = dense + static_cast<int64_t>(r) * n;
    for (int j = 0; j < 2 * K; ++j) drow[irow[j]] = add_rn(drow[irow[j]], vrow[j]);
  }
}

template <typename T>
int launch(const void* prev, int source, const void* receivers, int n_rec, int max_len,
           void* nodes, const void* coords, int ndim, int n, const void* U, const void* partners,
           int P, void* ids, void* vals, void* dense, cudaStream_t st) {
  const Terms<T> tm{static_cast<const T*>(coords), static_cast<const T*>(U),
                    static_cast<const int*>(partners), ndim, P};
  const unsigned blocks = static_cast<unsigned>((n_rec + kThreads - 1) / kThreads);
  paths_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(prev), source, static_cast<const int*>(receivers), n_rec, max_len,
      n, static_cast<int*>(nodes), tm, static_cast<int*>(ids), static_cast<T*>(vals),
      static_cast<T*>(dense));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one walk of every receiver on `stream`; returns the CUDA error
// as an int (0 when the launch was accepted).  prev (n) and receivers
// (n_rec) int32; nodes (n_rec, max_len) int32.  coords (ndim, n), U (n)
// float32, or float64 when is_double, and partners (n, P) int32 give the
// sensitivity rows: ids (n_rec, 2*(max_len-1)) int32 and vals of U's
// type; dense (n_rec, n) of U's type, zeroed by the caller, may be null.
// With coords null only nodes is written (ids, vals and dense are then
// ignored).  All contiguous device memory.
extern "C" int paths_launch(const void* prev, int source, const void* receivers, int n_rec,
                            int max_len, void* nodes, const void* coords, int ndim, int n,
                            const void* U, const void* partners, int P, void* ids, void* vals,
                            void* dense, int is_double, void* stream) {
  if (n_rec < 0 || max_len < 1 || n < 1 || !prev || !receivers || !nodes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rec == 0) return 0;
  const bool terms = coords != nullptr;
  if (terms && (ndim < 1 || P < 1 || !U || !partners || !ids || !vals))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!terms) ids = vals = dense = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(prev, source, receivers, n_rec, max_len, nodes, coords, ndim,
                                    n, U, partners, P, ids, vals, dense, st)
                   : launch<float>(prev, source, receivers, n_rec, max_len, nodes, coords, ndim,
                                   n, U, partners, P, ids, vals, dense, st);
}
