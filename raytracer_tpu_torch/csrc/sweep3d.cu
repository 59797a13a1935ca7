// T Jacobi sweeps of the 26-tap 3-D min-plus stencil (solve3d's kernel
// engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/sweep3d.py
// _make_sweep3d_kernel / sweep3d_T_batched.  Python wrappers and plain
// PyTorch twin: raytracer_tpu_torch/ops/sweep3d.py (sweep3d_T,
// sweep3d_T_batched, sweep3d_reference).
//
// What it computes.  A field is the (n2, n1, n0) travel-time box
// flattened to rows = k*n1 + j and lanes = i, padded to (nb*br, l0) with
// l0 a multiple of 128.  For each source slot q, each sweep t = 1..T and
// each padded point (row, lane):
//   out[q,row,lane] = min(in[q,row,lane], min over the 26 taps (dk,dj,di)
//                         of in[q, row + dk*n1 + dj, (lane + di) mod l0]
//                            + w4[row / br, tap, row mod br, lane])
// where a row outside [0, nb*br) reads +inf (the TPU kernel's H8 pad
// rows).  The weights are +inf across the box faces and in the padding,
// so every read that wraps a lane or crosses a j-row is masked by its
// weight, and padded points keep their input (+inf).  A tap whose weight
// is +inf, or whose row is outside the field, is skipped: its candidate
// is +inf.  Each candidate is one add (no multiply, so nothing to fuse)
// and the minimum does not depend on order, so this gives the floats of
// the twin and of the Pallas kernel in float32 and float64.
//
// Design.  Jacobi with ping-pong: sweep t reads what sweep t-1 wrote and
// never updates in place (Gauss-Seidel would change the floats and the
// iteration counts).  One kernel launch per sweep, from one launch
// function that loops over T on the stream; the last sweep writes `out`.
// One thread per padded point, threads along lanes, so the weight and
// field reads of a warp are coalesced.  A thread loads its 26 weights
// and tap offsets once per sweep and relaxes all S fields with them: the
// weight stream is read once per sweep for the whole source group, as
// in the TPU kernel.  Neighbour reads go through L1 and L2 (a 1M-node
// field is 4.3 MB in float32, well inside the 50 MB L2).
//
// What bounds it on an H100.  At 128x128x64 (1,048,576 nodes; nb=8,
// br=1024, l0=128) the weights are 109 MB, more than the 50 MB L2, so
// each sweep streams them from device memory again: T sweeps move at
// least T*109 MB, 0.26 ms at 3.35 TB/s for T=8, against about
// 2 x 26 x 1M x S x T add and min operations (0.03 ms at 67 TFLOP/s
// f32 for S=1).  Bytes bound it; sharing each weight load among S
// fields is what the design does about that.  chip_smoke.py recomputes
// the bound from its run's inputs.  A shared-memory tile of the rows a
// block reads, and TMA for the weight stream, are later work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 26;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep3d_kernel(const T* __restrict__ in, const T* __restrict__ w4,
               T* __restrict__ out, int s_count, int n1, int br, int nb,
               int l0) {
  const int page = nb * br * l0;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= page) return;
  const int rows = nb * br;
  const int row = p / l0;
  const int lane = p - row * l0;
  const int b = row / br;
  const int rr = row - b * br;
  const T* wp = w4 + (static_cast<size_t>(b) * kTaps * br + rr) * l0 + lane;
  const size_t wstride = static_cast<size_t>(br) * l0;  // one tap's slab

  // the point's 26 weights and tap offsets, shared by all S fields;
  // offset -1 marks a tap with no finite candidate
  T w[kTaps];
  int off[kTaps];
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    if (t == 13) continue;  // (0, 0, 0)
    const int s = t < 13 ? t : t - 1;
    const int dk = t / 9 - 1, dj = (t / 3) % 3 - 1, di = t % 3 - 1;
    w[s] = wp[s * wstride];
    const int nrow = row + dk * n1 + dj;
    int nl = lane + di;
    nl = nl < 0 ? nl + l0 : (nl >= l0 ? nl - l0 : nl);
    const bool live = nrow >= 0 && nrow < rows && !isinf(w[s]);
    off[s] = live ? nrow * l0 + nl : -1;
  }
  for (int q = 0; q < s_count; ++q) {
    const T* f = in + static_cast<size_t>(q) * page;
    T acc = f[p];
#pragma unroll
    for (int s = 0; s < kTaps; ++s) {
      if (off[s] < 0) continue;
      const T c = add_rn(f[off[s]], w[s]);
      acc = c < acc ? c : acc;
    }
    out[static_cast<size_t>(q) * page + p] = acc;
  }
}

template <typename T>
int run(const void* in, const void* w4, void* out, void* scratch,
        int s_count, int n1, int br, int nb, int l0, int t_sweeps,
        cudaStream_t st) {
  const int page = nb * br * l0;
  const int blocks = (page + kThreads - 1) / kThreads;
  const T* src = static_cast<const T*>(in);
  for (int t = 1; t <= t_sweeps; ++t) {
    // ping-pong between scratch and out, ending in out
    T* dst = static_cast<T*>((t_sweeps - t) % 2 == 0 ? out : scratch);
    sweep3d_kernel<T><<<blocks, kThreads, 0, st>>>(
        src, static_cast<const T*>(w4), dst, s_count, n1, br, nb, l0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = dst;
  }
  return 0;
}

}  // namespace

// T sweeps on `stream`; returns the CUDA error of the launches as an int
// (0 when accepted).  in and out are (s_count, nb*br, l0) fields, scratch
// a second buffer of that size (unused when t_sweeps == 1; it may then be
// out), w4 the (nb, 26, br, l0) weights, all contiguous device memory of
// float32 (is_double == 0) or float64.  in is read only; in, out and
// scratch must not overlap.
extern "C" int sweep3d_launch(const void* in, const void* w4, void* out,
                              void* scratch, int s_count, int n1, int br,
                              int nb, int l0, int t_sweeps, int is_double,
                              void* stream) {
  if (s_count < 1 || n1 < 1 || br < 1 || nb < 1 || l0 < 1 || t_sweeps < 1 ||
      static_cast<long long>(nb) * br * l0 > INT_MAX ||
      (t_sweeps > 1 && scratch == out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? run<double>(in, w4, out, scratch, s_count, n1, br, nb, l0,
                           t_sweeps, st)
             : run<float>(in, w4, out, scratch, s_count, n1, br, nb, l0,
                          t_sweeps, st);
}
