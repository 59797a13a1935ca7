// The banded solver's two steps on an RCM-ordered graph: a Jacobi
// iteration (banded_sweep) and one Gauss-Seidel direction (banded_gs).
//
// Kernels of the port's own choice: the JAX package runs both as XLA
// (raytracer_tpu/ops/banded.py: the body of _solve_banded_jit, and one
// direction of _solve_banded_gs_jit's sweep with its merge), with no
// Pallas kernel.  Python wrappers, tables and plain PyTorch twins:
// raytracer_tpu_torch/ops/banded.py (banded_step, banded_gs, tap_lists,
// banded_step_reference, banded_gs_reference); the halo groups:
// ops/graph.halo_by_destination.
//
// What they compute.  Fields (S, n_pad) float32 or float64 (one template
// build a type) in the permuted order.  The JAX package keeps the weights
// as dense diagonals, W[o][i] the weight of edge (i+o -> i), +inf where no
// edge exists; the kernels read the finite entries of each row as a tap
// list, CSR by row (toff (n_pad+1), tcol the source row i+o, tw the
// weight).  A +inf tap never wins a minimum, each candidate is one
// __fadd_rn / __dadd_rn and the minimum does not depend on order, so the
// floats are those of the dense rolls.
//   banded_sweep_kernel, a thread a (field, row): with active = changed_in
//     && it_in < max_iters, v = min(dist0[i], dist0[tcol[t]] + tw[t] over
//     row i's taps) (jnp.minimum(dist, _banded_sweep(dist))); a halo
//     destination (didx[i] >= 0) also takes the same swept value of each
//     of its sources (the scatter-min reads every source after the sweep
//     and before any write: the thread sweeps the source rows itself);
//     changed_out = 1 where v < dist0[i], it_out = it_in + 1.  When not
//     active the field is copied through and it_out = it_in, changed_out
//     = changed_in, so the host reads the flag every few iterations.
//   banded_gs_kernel, a block of threads a field: the row blocks of B rows
//     strictly in order (ascending when forward), each block's rows in
//     shared memory twice; P passes a block, each a Jacobi update of the
//     block over its rows' taps that reads the block's rows as they stood
//     at the pass's start (the shared copy) and a row outside as it stood
//     when the block began: din for a block not yet reached in this
//     direction, the output for one already written; then the block's
//     rows go to the output.  halo_min_kernel then copies the field with
//     each halo destination's minimum over itself and its sources (every
//     source read from the copy before the merge).
//
// What bounds them on an H100.  On the production Delaunay annulus
// (47,616 rows, 496,032 finite taps, mean 10.4 a row) a Jacobi iteration
// reads the taps once (~4 MB in float32 with their rows and offsets) and
// the field: ~0.0012 ms at 3.35 TB/s, so one launch (~3 us) bounds it;
// the gathers of dist0 at i+o stay within the band and in L1/L2.  The
// Gauss-Seidel direction is a chain of 93 blocks x 2 passes, each waiting
// on the last (a block barrier between passes), on one SM a field: it is
// latency-bound by design (it takes ~6x fewer sweeps than Jacobi).

#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::min_of;

constexpr int kThreads = 256;
constexpr int kGsMaxThreads = 1024;

// min(d0[r], d0[tcol[t]] + tw[t] over row r's taps)
template <typename T>
__device__ __forceinline__ T swept(const T* __restrict__ d0, int r, const int* __restrict__ toff,
                                   const int* __restrict__ tcol, const T* __restrict__ tw) {
  T v = d0[r];
  const int t1 = toff[r + 1];
  for (int t = toff[r]; t < t1; ++t) v = min_of(v, add_rn(d0[tcol[t]], tw[t]));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_sweep_kernel(const T* __restrict__ dist0, T* __restrict__ dist1,
                        const int* __restrict__ toff, const int* __restrict__ tcol,
                        const T* __restrict__ tw, const int* __restrict__ didx,
                        const int* __restrict__ hoff, const int* __restrict__ hsrc,
                        const int* __restrict__ it_in, const int* __restrict__ changed_in,
                        int* __restrict__ it_out, int* __restrict__ changed_out, int S,
                        int n_pad, int max_iters) {
  const bool active = *changed_in != 0 && *it_in < max_iters;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *it_out = *it_in + (active ? 1 : 0);
    if (!active) *changed_out = *changed_in;
  }
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(S) * n_pad) return;
  const int b = static_cast<int>(idx / n_pad);
  const int i = static_cast<int>(idx - static_cast<long long>(b) * n_pad);
  const T* d0 = dist0 + static_cast<size_t>(b) * n_pad;
  const T x = d0[i];
  if (!active) {
    dist1[idx] = x;
    return;
  }
  T v = swept(d0, i, toff, tcol, tw);
  const int g = didx[i];
  if (g >= 0)
    for (int h = hoff[g]; h < hoff[g + 1]; ++h) v = min_of(v, swept(d0, hsrc[h], toff, tcol, tw));
  dist1[idx] = v;
  if (v < x) *changed_out = 1;
}

template <typename T>
__global__ void __launch_bounds__(kGsMaxThreads)
    banded_gs_kernel(const T* __restrict__ din, T* __restrict__ dout,
                     const int* __restrict__ toff, const int* __restrict__ tcol,
                     const T* __restrict__ tw, int n_pad, int B, int P, int forward) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + B;
  const T* in = din + static_cast<size_t>(blockIdx.x) * n_pad;
  T* out = dout + static_cast<size_t>(blockIdx.x) * n_pad;
  const int NB = n_pad / B;
  for (int g = 0; g < NB; ++g) {
    const int r0 = (forward ? g : NB - 1 - g) * B;
    const int r1 = r0 + B;
    for (int i = threadIdx.x; i < B; i += blockDim.x) buf0[i] = in[r0 + i];
    __syncthreads();
    T* cur = buf0;
    T* nxt = buf1;
    for (int p = 0; p < P; ++p) {
      for (int i = threadIdx.x; i < B; i += blockDim.x) {
        const int r = r0 + i;
        T v = cur[i];
        const int t1 = toff[r + 1];
        for (int t = toff[r]; t < t1; ++t) {
          const int j = tcol[t];
          T src;
          if (j >= r0 && j < r1)
            src = cur[j - r0];
          else if (forward ? j < r0 : j >= r1)
            src = out[j];  // a block already written in this direction
          else
            src = in[j];   // a block not reached yet
          v = min_of(v, add_rn(src, tw[t]));
        }
        nxt[i] = v;
      }
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int i = threadIdx.x; i < B; i += blockDim.x) out[r0 + i] = cur[i];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_min_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ didx,
                    const int* __restrict__ hoff, const int* __restrict__ hsrc, int S,
                    int n_pad) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(S) * n_pad) return;
  const int b = static_cast<int>(idx / n_pad);
  const int i = static_cast<int>(idx - static_cast<long long>(b) * n_pad);
  const T* xb = x + static_cast<size_t>(b) * n_pad;
  T v = xb[i];
  const int g = didx[i];
  if (g >= 0)
    for (int h = hoff[g]; h < hoff[g + 1]; ++h) v = min_of(v, xb[hsrc[h]]);
  y[idx] = v;
}

unsigned grid_of(int S, int n_pad) {
  return static_cast<unsigned>((static_cast<long long>(S) * n_pad + kThreads - 1) / kThreads);
}

template <typename T>
int launch_sweep(const void* dist0, void* dist1, const void* toff, const void* tcol,
                 const void* tw, const void* didx, const void* hoff, const void* hsrc,
                 const void* it_in, const void* changed_in, void* it_out, void* changed_out,
                 int S, int n_pad, int max_iters, cudaStream_t st) {
  banded_sweep_kernel<T><<<grid_of(S, n_pad), kThreads, 0, st>>>(
      static_cast<const T*>(dist0), static_cast<T*>(dist1), static_cast<const int*>(toff),
      static_cast<const int*>(tcol), static_cast<const T*>(tw), static_cast<const int*>(didx),
      static_cast<const int*>(hoff), static_cast<const int*>(hsrc),
      static_cast<const int*>(it_in), static_cast<const int*>(changed_in),
      static_cast<int*>(it_out), static_cast<int*>(changed_out), S, n_pad, max_iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gs(const void* din, void* dtmp, void* dout, const void* toff, const void* tcol,
              const void* tw, const void* didx, const void* hoff, const void* hsrc, int n_dest,
              int S, int n_pad, int B, int P, int forward, int smem, cudaStream_t st) {
  if (static_cast<size_t>(smem) != 2 * static_cast<size_t>(B) * sizeof(T))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_gs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const int threads = B >= kGsMaxThreads ? kGsMaxThreads : ((B + 31) / 32) * 32;
  T* swept_out = static_cast<T*>(n_dest > 0 ? dtmp : dout);
  banded_gs_kernel<T><<<S, threads, smem, st>>>(
      static_cast<const T*>(din), swept_out, static_cast<const int*>(toff),
      static_cast<const int*>(tcol), static_cast<const T*>(tw), n_pad, B, P, forward);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_dest == 0) return static_cast<int>(e);
  halo_min_kernel<T><<<grid_of(S, n_pad), kThreads, 0, st>>>(
      swept_out, static_cast<T*>(dout), static_cast<const int*>(didx),
      static_cast<const int*>(hoff), static_cast<const int*>(hsrc), S, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one Jacobi iteration on `stream`; returns the CUDA error as an
// int (0 when the launch was accepted).  dist0/dist1 (S, n_pad) float32,
// or float64 when is_double; toff (n_pad+1), tcol, tw (tw of dist's type)
// the tap lists; didx (n_pad), hoff (D+1), hsrc int32 the halo groups
// (tcol, tw and hsrc may be empty);
// it_in, changed_in, it_out, changed_out one int32 each, changed_out
// zeroed by the caller.  All contiguous device memory.
extern "C" int banded_sweep_launch(const void* dist0, void* dist1, const void* toff,
                                   const void* tcol, const void* tw, const void* didx,
                                   const void* hoff, const void* hsrc, const void* it_in,
                                   const void* changed_in, void* it_out, void* changed_out,
                                   int S, int n_pad, int max_iters, int is_double,
                                   void* stream) {
  if (S < 1 || n_pad < 1 || max_iters < 0 || !dist0 || !dist1 || !toff || !didx || !hoff ||
      !it_in || !changed_in || !it_out || !changed_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_sweep<double>(dist0, dist1, toff, tcol, tw, didx, hoff, hsrc, it_in,
                                          changed_in, it_out, changed_out, S, n_pad,
                                          max_iters, st)
                   : launch_sweep<float>(dist0, dist1, toff, tcol, tw, didx, hoff, hsrc, it_in,
                                         changed_in, it_out, changed_out, S, n_pad,
                                         max_iters, st);
}

// Launches one Gauss-Seidel direction (and, with n_dest halo destinations,
// the merge) on `stream`; returns the CUDA error as an int.  din, dout
// (S, n_pad) and dtmp (the swept field before the merge; unused when
// n_dest is 0) of one type; the tap lists and halo groups as for
// banded_sweep_launch; B divides n_pad; smem = 2 B sizeof(T) bytes.  One
// block a field.
extern "C" int banded_gs_launch(const void* din, void* dtmp, void* dout, const void* toff,
                                const void* tcol, const void* tw, const void* didx,
                                const void* hoff, const void* hsrc, int n_dest, int S,
                                int n_pad, int B, int P, int forward, int smem, int is_double,
                                void* stream) {
  if (S < 1 || n_pad < 1 || B < 1 || n_pad % B != 0 || P < 0 || n_dest < 0 || smem < 1 ||
      static_cast<size_t>(smem) > minplus::kBlockSmem || !din || !dout || (n_dest > 0 && !dtmp) ||
      !toff || !didx || !hoff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_gs<double>(din, dtmp, dout, toff, tcol, tw, didx, hoff, hsrc, n_dest,
                                       S, n_pad, B, P, forward, smem, st)
                   : launch_gs<float>(din, dtmp, dout, toff, tcol, tw, didx, hoff, hsrc, n_dest,
                                      S, n_pad, B, P, forward, smem, st);
}
