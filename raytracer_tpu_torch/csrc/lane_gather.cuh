// The lane-gather relaxation of the circulant stencil, used by
// csrc/relax.cu (one sweep per launch, the 'pallas' engine).  csrc/fused.cu
// (the 'fused' engine) takes only its constants and arithmetic helpers;
// its relaxation reads chunk tables of its own.
//
// The state is (T, SR, 128) with SR = S * ntp rows, source-major: row
// r = s * ntp + c holds theta column c of source s, and rows c >= nt
// (ntp is nt rounded up to a multiple of 8) are padding.  The packed
// stencil gives, for each destination tile t, the rows k in
// [offs[t], offs[t+1]) of idx and w (K_tot x 128) and the rolled-source
// tile u_of[k] = (dc + 2) * T + source tile.  One relaxation is
//
//   acc[t, r, l] = min(acc0, min over k of
//                      src[u_of[k] % T, s * ntp + (c + dc) mod nt,
//                          idx[k, l]] + w[k, l])
//
// which is the TPU kernel's gather from its 5 theta-rolled copies with
// the roll done in the index arithmetic (a roll moves values, it does no
// arithmetic, so the bits are the same).  Pad rows read +inf from every
// rolled copy, so their accumulator starts at +inf and stays there.
//
// Each candidate is one add (__fadd_rn / __dadd_rn: nothing for nvcc to
// contract) and the minimum does not depend on order, so the result is
// the plain versions' and the Pallas kernel's to the bit.  A row k whose
// weight is +inf for the lane gives an +inf candidate and is skipped.
// One thread takes kRows consecutive rows of one source block (ntp is a
// multiple of 8), so each idx/w load serves kRows gathers.
#pragma once

#include <cuda_runtime.h>

namespace lane_gather {

constexpr int kLanes = 128;
constexpr int kRows = 4;  // rows per thread; divides 8, so divides ntp

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ bool is_inf(float v) { return isinf(v); }
__device__ __forceinline__ bool is_inf(double v) { return isinf(v); }

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// acc[i] for rows r0 + i, i < kRows, of tile t at lane `lane`
template <typename T>
__device__ __forceinline__ void relax_rows(
    const T* src, const int* __restrict__ offs,
    const int* __restrict__ u_of, const int* __restrict__ idx,
    const T* __restrict__ w, int t, int r0, int lane, int t_tiles, int nt,
    int ntp, int sr, T (&acc)[kRows]) {
  const int s0 = (r0 / ntp) * ntp;  // first row of this source block
  const int c0 = r0 - s0;
  const size_t tile = static_cast<size_t>(sr) * kLanes;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    acc[i] = c0 + i < nt ? src[t * tile + static_cast<size_t>(r0 + i) * kLanes + lane]
                         : pos_inf<T>();
  if (c0 >= nt) return;  // all pad: +inf
  const int k1 = offs[t + 1];
  for (int k = offs[t]; k < k1; ++k) {
    const T wv = w[static_cast<size_t>(k) * kLanes + lane];
    if (is_inf(wv)) continue;
    const int u = u_of[k];
    const int q = u / t_tiles;
    const int dc = q - 2;
    const T* base = src + static_cast<size_t>(u - q * t_tiles) * tile +
                    idx[static_cast<size_t>(k) * kLanes + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int c = c0 + i;
      if (c >= nt) continue;
      int cc = c + dc;  // |dc| <= 2 < nt: one wrap at most
      cc = cc < 0 ? cc + nt : (cc >= nt ? cc - nt : cc);
      const int row = s0 + cc;
      const T cand = add_rn(base[static_cast<size_t>(row) * kLanes], wv);
      acc[i] = cand < acc[i] ? cand : acc[i];
    }
  }
}

}  // namespace lane_gather
