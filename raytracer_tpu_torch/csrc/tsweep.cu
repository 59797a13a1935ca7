// One directional theta-column sweep of the xla sweep engine, one block a
// source.
//
// A kernel of the port's own choice: the JAX package runs this sweep as
// XLA, a sequential lax.scan over the theta columns
// (raytracer_tpu/ops/sweep_theta.py _sweep), with no Pallas kernel.  As
// torch ops one column is some tens of launches, thousands a sweep at
// 180x63, which the theta-sharded solve (parallel/theta_shard.py) runs
// twice a round.  Python wrapper and plain PyTorch twin:
// raytracer_tpu_torch/ops/sweep_theta.py (tsweep, _sweep).
//
// What it computes.  v (S, nt, ML) of type T (float or double, one
// template build a type).  The columns are visited in order c = 0 .. nt-1
// (forward) or nt-1 .. 0 (reverse); p1 and p2 are the columns processed
// one and two steps before, seeded from carry1 / carry2 ((S, ML), the
// neighbour block's halo columns of the theta-sharded solve) or, when
// those are null, from the field's own last two columns in processing
// order.  For column c, lane m (all lane indices mod ML, jnp.roll's wrap):
//   1. cur = v[c, m], then cur = min(cur, p1[m + d1[i]] + w1[i, m]) for the
//      n1 taps of dc = -1 (forward) or +1 (reverse), and the same from p2
//      for the n2 taps of dc = -+2;
//   2. when col_relax, each dc = 0 tap i in order, a Jacobi update of the
//      whole column: cur[m] = min(cur[m], cur[m + d0[i]] + w0[i, m]); then
//      the chain scans, span by span: cur[m] = min(cur[m], cur[m - s_k] +
//      cfp[k, m]) for every k, then cur[m] = min(cur[m], cur[m + s_k] +
//      cbp[k, m]);
//   3. out[c] = cur, and cur becomes p1, p1 becomes p2.
// Every candidate is one add (add_rn, never contracted) and the minimum is
// exact, so out is the plain twin's bit for bit.  offs holds the int32
// offsets d1 (n1), d2 (n2), d0 (n0), then the spans s (L).
//
// What bounds it on an H100.  The columns are a chain: each of the n0 +
// 2L in-column steps of a column reads the whole column as the previous
// step left it, so a sweep is nt * (1 + n0 + 2L) dependent steps (about
// 180 * 25 at 180x63), each a shared-memory round trip and a block-wide
// barrier.  Its bound (chip_smoke.py, _tsweep_work) is the larger of the
// bytes (the field read and written once, the finite weights once: 1.68
// MB at 180x63, one source, float32, 0.0005 ms at 3.35 TB/s) and the
// operations (an add and a min per finite candidate: 34.9 M, 0.00052 ms
// at 67 TFLOP/s; float64 0.00103 ms), so the launch is latency-bound and
// uses one SM a source.  The simple design stands:
// the column and its two predecessors in shared memory, a thread a lane
// (a thread loops when ML exceeds the block), one barrier a step.

#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::min_of;

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tsweep_kernel(const T* __restrict__ v, T* __restrict__ out, const T* __restrict__ carry1,
                  const T* __restrict__ carry2, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w0,
                  const T* __restrict__ cfp, const T* __restrict__ cbp,
                  const int* __restrict__ offs, int n1, int n2, int n0, int L, int nt, int ML,
                  int reverse, int col_relax) {
  extern __shared__ unsigned char smem_raw[];
  T* bufs[4];
  bufs[0] = reinterpret_cast<T*>(smem_raw);
  for (int b = 1; b < 4; ++b) bufs[b] = bufs[b - 1] + ML;
  T* p1 = bufs[0];
  T* p2 = bufs[1];
  T* cur = bufs[2];
  T* nxt = bufs[3];
  const int* d1 = offs;
  const int* d2 = d1 + n1;
  const int* d0 = d2 + n2;
  const int* span = d0 + n0;
  const size_t col = static_cast<size_t>(ML);
  const T* vs = v + static_cast<size_t>(blockIdx.x) * nt * col;
  T* os = out + static_cast<size_t>(blockIdx.x) * nt * col;
  const int nth = blockDim.x;

  // the carry: the neighbour's halo columns, or this field's own wrap
  // columns in processing order (Gauss-Seidel staleness)
  const T* src1 = carry1 ? carry1 + blockIdx.x * col
                         : vs + static_cast<size_t>(reverse ? 0 : nt - 1) * col;
  const T* src2 = carry2 ? carry2 + blockIdx.x * col
                         : vs + static_cast<size_t>(reverse ? 1 : nt - 2) * col;
  for (int m = threadIdx.x; m < ML; m += nth) {
    p1[m] = src1[m];
    p2[m] = src2[m];
  }
  __syncthreads();

  for (int k = 0; k < nt; ++k) {
    const int c = reverse ? nt - 1 - k : k;
    // 1. the taps from the two columns before
    for (int m = threadIdx.x; m < ML; m += nth) {
      T x = vs[c * col + m];
      for (int i = 0; i < n1; ++i)
        x = min_of(x, add_rn(p1[wrap(m + d1[i], ML)], w1[i * col + m]));
      for (int i = 0; i < n2; ++i)
        x = min_of(x, add_rn(p2[wrap(m + d2[i], ML)], w2[i * col + m]));
      cur[m] = x;
    }
    __syncthreads();
    // 2. the in-column taps and the chain scans, one Jacobi step each
    if (col_relax) {
      const int steps = n0 + 2 * L;
      for (int t = 0; t < steps; ++t) {
        int d;
        const T* w;
        if (t < n0) {
          d = d0[t];
          w = w0 + t * col;
        } else if (t < n0 + L) {
          d = -span[t - n0];
          w = cfp + (t - n0) * col;
        } else {
          d = span[t - n0 - L];
          w = cbp + (t - n0 - L) * col;
        }
        for (int m = threadIdx.x; m < ML; m += nth)
          nxt[m] = min_of(cur[m], add_rn(cur[wrap(m + d, ML)], w[m]));
        __syncthreads();
        T* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
    // 3. the column out; it becomes p1 and p1 becomes p2 (each thread
    // writes only its own lanes of cur, which it reads back here)
    for (int m = threadIdx.x; m < ML; m += nth) os[c * col + m] = cur[m];
    T* old_p2 = p2;
    p2 = p1;
    p1 = cur;
    cur = old_p2;
    // the next column's step 1 writes cur (the old p2, last read before
    // this column's first barrier) and reads p1 (written before the last
    // barrier), so no barrier is needed here
  }
}

template <typename T>
int launch(const void* v, void* out, const void* carry1, const void* carry2, const void* w1,
           const void* w2, const void* w0, const void* cfp, const void* cbp, const void* offs,
           int S, int nt, int ML, int n1, int n2, int n0, int L, int reverse, int col_relax,
           int threads, cudaStream_t st) {
  const size_t smem = 4 * static_cast<size_t>(ML) * sizeof(T);
  if (smem > minplus::kBlockSmem || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tsweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  tsweep_kernel<T><<<S, threads, smem, st>>>(
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<const T*>(carry1),
      static_cast<const T*>(carry2), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w0), static_cast<const T*>(cfp), static_cast<const T*>(cbp),
      static_cast<const int*>(offs), n1, n2, n0, L, nt, ML, reverse, col_relax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one sweep on `stream`; returns the CUDA error as an int (0 when
// the launch was accepted).  v and out (S, nt, ML), carry1 and carry2 (S,
// ML) or both null, w1 (n1, ML), w2 (n2, ML), w0 (n0, ML), cfp and cbp (L,
// ML): float32, or float64 when is_double; offs (n1 + n2 + n0 + L) int32;
// all contiguous device memory, out not overlapping v.  One block of
// `threads` threads (a multiple of 32, at most 1,024) a source, with
// 4 * ML values of dynamic shared memory.
extern "C" int tsweep_launch(const void* v, void* out, const void* carry1, const void* carry2,
                             const void* w1, const void* w2, const void* w0, const void* cfp,
                             const void* cbp, const void* offs, int S, int nt, int ML, int n1,
                             int n2, int n0, int L, int reverse, int col_relax, int threads,
                             int is_double, void* stream) {
  if (S < 1 || nt < 2 || ML < 1 || n1 < 0 || n2 < 0 || n0 < 0 || L < 0 ||
      (!carry1) != (!carry2) || static_cast<long long>(nt) * ML > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(v, out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt,
                                    ML, n1, n2, n0, L, reverse, col_relax, threads, st)
                   : launch<float>(v, out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt,
                                   ML, n1, n2, n0, L, reverse, col_relax, threads, st);
}
