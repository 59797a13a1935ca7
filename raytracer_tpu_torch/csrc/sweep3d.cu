// T Jacobi sweeps of the 26-tap 3-D min-plus stencil (solve3d's kernel
// engine).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/sweep3d.py
// _make_sweep3d_kernel / sweep3d_T_batched.  Python wrappers, the
// mirrored weight layout and the plain PyTorch twins:
// raytracer_tpu_torch/ops/sweep3d.py (sweep3d_T, sweep3d_T_batched,
// mirror_weights, sweep3d_reference, sweep3d_mirrored_reference).
//
// What it computes.  A field is the (n2, n1, n0) travel-time box
// flattened to rows = k*n1 + j and lanes = i, padded to (P, l0) rows and
// lanes (P = nb*br, l0 a multiple of 128).  For each source slot q, each
// sweep t = 1..T and each padded point (row, lane):
//   out[q,row,lane] = min(in[q,row,lane], min over the 26 taps (dk,dj,di)
//                         of in[q, row + dk*n1 + dj, (lane + di) mod l0]
//                            + W4[row / br, tap, row mod br, lane])
// where a row outside [0, P) reads +inf (the TPU kernel's H8 pad rows).
// Each candidate is one add and the minimum does not depend on order,
// so any order of taps and any tiling gives the floats of the twin and
// of the Pallas kernel in float32 and float64.
//
// The weights are symmetric: the tap -s at point p is the edge that the
// tap s carries at p - s, with the same weight bit for bit (the edge
// weight 2L/(U1+U2) is symmetric in its two ends).  So the kernel reads
// the 13 taps s = 0..12 (dk = -1, or dk = 0 and dj = -1, or (0,0,-1)) at
// p from m13 (13, P, l0) = W4's taps 0..12, and the mirror taps 25 - s at
// p from m13[s] at p - s, or +inf where p - s leaves the box in j or the
// rows.  A neighbour read that leaves [0, n1) in j reads +inf.
// solvers/solve3d._device_layout derives m13 once per upload and checks
// on the device, bit for bit, that the 26 weights this implies equal W4
// (mirror_weights); so the kernel's candidates are the twin's.
//
// What bounds it on an H100.  Bytes: at 128x128x64 (1,048,576 nodes) the
// 26 weights are 109 MB, more than the 50 MB L2, so a kernel that reads
// all of them in each of the T sweeps moves them from device memory T
// times (0.26 ms for T = 8 at 3.35 TB/s, its floor).  This design reads 13 weights a node
// from device memory per sweep (54.5 MB): the mirror reads of plane k+1
// are the own reads of the next step, and a bulk L2 prefetch brings each
// plane's weights in a step ahead.  Each field value is used by 27
// points, so a CTA walks kc k-planes of tj j-rows x lc lanes (all l0
// where they fit) and keeps a ring of four plane tiles (a one-row halo
// in j, the neighbouring lane on each side, mod l0) of up to sc fields in
// shared memory: cp.async fills plane k+2 while plane k is computed, and
// every point takes its 27 reads there.
// A point's weights are loaded once per sweep and shared by the fields
// of its chunk.  What is left: the 26 weight loads a point from L2 (the
// mirror half hits lines the own half of the next step reads again) at
// S = 1, and the 27 shared-memory reads a point and field at S = 7.  One
// launch per sweep (Jacobi: sweep t reads what sweep t-1 wrote),
// ping-pong between scratch and out.

#include <cuda_runtime.h>

#include <climits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = 13;  // taps 0..12; tap 25 - s mirrors tap s

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// the candidate minimum: no operand is NaN (weights are positive or +inf,
// travel times non-negative or +inf), so fmin is the twin's torch.minimum
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// kChunk: the CTA covers lc of the l0 lanes (false: all of them, and the
// compiler sees lc == l0 and no lane offset)
template <typename T, bool kChunk>
__global__ void __launch_bounds__(kThreads)
sweep3d_march(const T* __restrict__ in, const T* __restrict__ m13,
              T* __restrict__ out, int s_count, int n1, int rows, int l0,
              int lc_arg, int tj, int kc, int sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte copy
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int planes = (rows + n1 - 1) / n1;
  const int jn = (n1 + tj - 1) / tj;
  const int lc = kChunk ? lc_arg : l0;
  const int cn = kChunk ? l0 / lc : 1;          // lane chunks
  const int c0 = kChunk ? (blockIdx.x % cn) * lc : 0;  // this CTA's first lane
  const int j0 = (blockIdx.x / cn % jn) * tj;
  const int kbeg = (blockIdx.x / cn / jn) * kc;
  const int kend = min(kbeg + kc, planes);
  const int hj = tj + 2;          // j-rows of a plane tile with the halo
  const int ls = lc + 8;          // tile row: lane c0-1 at 3, lanes c0.. at 4.., lane c0+lc at lc+4
  const int psz = hj * ls;        // one field's plane tile
  const int slot = sc * psz;      // one ring slot: a plane of every field of the chunk
  const int chunks = lc / 32;     // lc is a multiple of 128
  const int vecs = lc / kVec;
  const size_t page = static_cast<size_t>(rows) * l0;
  const T inf = inf_of<T>();

  // the weights of plane k of this CTA's j-rows into L2, so that the
  // mirror reads of the step before the plane's own find them there
  const auto prefetch_weights = [&](int k) {
    const int r0 = k * n1 + j0;
    const int nr = min(min(tj, n1 - j0), rows - r0);
    if (k < planes && nr > 0 && threadIdx.x < kHalf)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       m13 + threadIdx.x * page + static_cast<size_t>(r0) * l0),
                   "r"(static_cast<unsigned>(nr * l0 * sizeof(T))));
  };

  for (int q0 = 0; q0 < s_count; q0 += sc) {
    const int nq = min(sc, s_count - q0);
    // plane k of nq fields into ring slot k & 3: cp.async inside the box,
    // +inf outside it; one commit group per plane
    const auto fill = [&](int k) {
      T* base = ring + (k & 3) * slot;
      for (int i = threadIdx.x; i < nq * hj * (vecs + 2); i += kThreads) {
        const int r = i / (vecs + 2), v = i - r * (vecs + 2);
        const int q = r / hj, jj = r - q * hj;
        const int j = j0 - 1 + jj;
        const int row = k * n1 + j;
        T* dst = base + q * psz + jj * ls + 4;
        if (k >= 0 && j >= 0 && j < n1 && row < rows) {
          const T* src = in + (q0 + q) * page + static_cast<size_t>(row) * l0;
          if (v < vecs) cp_async16(dst + kVec * v, src + c0 + kVec * v);
          else if (v == vecs)
            cp_async_ca<sizeof(T)>(dst - 1, src + (kChunk ? (c0 + l0 - 1) % l0 : l0 - 1));
          else cp_async_ca<sizeof(T)>(dst + lc, src + (kChunk ? (c0 + lc) % l0 : 0));
        } else if (v < vecs) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) dst[kVec * v + e] = inf;
        } else {
          dst[v == vecs ? -1 : lc] = inf;
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    if (q0) __syncthreads();  // the last chunk's ring reads are done
    if (q0 == 0) {
      prefetch_weights(kbeg);
      prefetch_weights(kbeg + 1);
    }
    fill(kbeg - 1);
    fill(kbeg);
    fill(kbeg + 1);
    for (int k = kbeg; k < kend; ++k) {
      cp_async_wait_all();
      __syncthreads();  // planes k-1..k+1 are in; plane k-2's slot is free
      fill(k + 2);
      if (q0 == 0) prefetch_weights(k + 2);
      const T* pl[3] = {ring + ((k - 1) & 3) * slot, ring + (k & 3) * slot,
                        ring + ((k + 1) & 3) * slot};
      // the points of plane k: each warp takes 32 lanes of one j-row
      for (int it = warp; it < tj * chunks; it += kWarps) {
        const int b = it / chunks, tl = (it - b * chunks) * 32 + lid;
        const int lane = c0 + tl;
        const int j = j0 + b;
        const int row = k * n1 + j;
        if (j >= n1 || row >= rows) continue;
        const int centre = (b + 1) * ls + 4 + tl;
        const size_t at = static_cast<size_t>(row) * l0 + lane;
        T w[kHalf], wm[kHalf];
#pragma unroll
        for (int s = 0; s < kHalf; ++s) {
          const int dk = s / 9 - 1, dj = (s / 3) % 3 - 1, di = s % 3 - 1;
          w[s] = m13[s * page + at];
          // mirror tap -(dk, dj, di): its weight is tap s's at p - s
          const int jm = j - dj, rm = row - dk * n1 - dj;
          int lm = lane - di;
          lm = lm < 0 ? lm + l0 : (lm >= l0 ? lm - l0 : lm);
          wm[s] = (jm >= 0 && jm < n1 && rm >= 0 && rm < rows)
                      ? m13[s * page + static_cast<size_t>(rm) * l0 + lm]
                      : inf;
        }
        for (int q = 0; q < nq; ++q) {
          const int c = q * psz + centre;
          T acc = pl[1][c];
#pragma unroll
          for (int s = 0; s < kHalf; ++s) {
            const int dk = s / 9 - 1, dj = (s / 3) % 3 - 1, di = s % 3 - 1;
            const int off = dj * ls + di;
            acc = min_of(acc, add_rn(pl[1 + dk][c + off], w[s]));
            acc = min_of(acc, add_rn(pl[1 - dk][c - off], wm[s]));
          }
          out[(q0 + q) * page + at] = acc;
        }
      }
    }
    cp_async_wait_all();  // no copy may outlive the CTA
  }
}

template <typename T>
int run(const void* in, const void* m13, void* out, void* scratch,
        int s_count, int n1, int rows, int l0, int t_sweeps, int lc, int tj,
        int kc, int sc, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(4) * sc * (tj + 2) * (lc + 8) * sizeof(T);
  const bool chunk = lc != l0;
  static size_t smem_set[2] = {0, 0};
  if (smem > smem_set[chunk]) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk ? sweep3d_march<T, true> : sweep3d_march<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[chunk] = smem;
  }
  const int planes = (rows + n1 - 1) / n1;
  const int blocks = ((planes + kc - 1) / kc) * ((n1 + tj - 1) / tj) * (l0 / lc);
  const T* src = static_cast<const T*>(in);
  for (int t = 1; t <= t_sweeps; ++t) {
    // ping-pong between scratch and out, ending in out
    T* dst = static_cast<T*>((t_sweeps - t) % 2 == 0 ? out : scratch);
    if (chunk)
      sweep3d_march<T, true><<<blocks, kThreads, smem, st>>>(
          src, static_cast<const T*>(m13), dst, s_count, n1, rows, l0, lc, tj,
          kc, sc);
    else
      sweep3d_march<T, false><<<blocks, kThreads, smem, st>>>(
          src, static_cast<const T*>(m13), dst, s_count, n1, rows, l0, lc, tj,
          kc, sc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = dst;
  }
  return 0;
}

}  // namespace

// T sweeps on `stream`; returns the CUDA error of the launches as an int
// (0 when accepted).  in and out are (s_count, rows, l0) fields, scratch
// a second buffer of that size (unused when t_sweeps == 1; it may then be
// out), m13 the (13, rows, l0) mirrored weights (mirror_weights), all
// contiguous device memory of float32 (is_double == 0) or float64.  A
// CTA walks kc k-planes of tj j-rows x lc lanes (a multiple of 128 that
// divides l0), sc fields at a time.
// in is read only; in, out and scratch must not overlap.
extern "C" int sweep3d_launch(const void* in, const void* m13, void* out,
                              void* scratch, int s_count, int n1, int rows,
                              int l0, int t_sweeps, int lc, int tj, int kc,
                              int sc, int is_double, void* stream) {
  if (s_count < 1 || n1 < 1 || rows < 1 || l0 < 128 || l0 % 128 ||
      lc < 128 || lc % 128 || l0 % lc ||
      t_sweeps < 1 || tj < 1 || kc < 1 || sc < 1 ||
      static_cast<long long>(rows) * l0 * s_count > INT_MAX ||
      (t_sweeps > 1 && scratch == out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? run<double>(in, m13, out, scratch, s_count, n1, rows, l0,
                           t_sweeps, lc, tj, kc, sc, st)
             : run<float>(in, m13, out, scratch, s_count, n1, rows, l0,
                          t_sweeps, lc, tj, kc, sc, st);
}
