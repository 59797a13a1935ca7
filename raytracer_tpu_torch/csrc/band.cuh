// Band sweep of the theta-major Jacobi engines: one output point.
//
// Shared by csrc/band.cu (the 'stream' engine's band kernel) and
// csrc/titer.cu (the band phase of the 'twrapped' engine's iterations).
//
// The TPU kernels run the band sweep in a moving frame: the accumulator
// is rolled one lane per trip over the 2*maxdm+1 slot offsets while the
// 5 theta-shifted pages stay put, and the weight rows are stored shifted
// into source-slot coordinates.  Unrolled, one output point is
//
//   out[m] = min(cur[m], min over dm in [-maxdm, maxdm], u in [0, 5) of
//                page[u][(m+dm) mod ML]
//                + wrows[(dm+maxdm)*5 + u][(m+dm) mod ML])
//
// where page[u] is the field shifted by dc = u-2 theta rows.  Each
// candidate is one f32 add and min does not depend on order, so this
// gives the same floats as the TPU kernel.  Pad lanes [Mp, ML) hold +inf
// in every weight row, so reads that wrap past the slot range are
// self-masking.

#pragma once

#include <cuda_runtime.h>

namespace band {

constexpr int kNdc = 5;  // theta offsets dc = -2..2

// page[u]: the row (ml floats) of the dc = u-2 page for this output's
// source and theta row, or nullptr where that page row is all +inf.
__device__ __forceinline__ float band_point(const float* const page[kNdc],
                                            const float* __restrict__ wrows,
                                            int ml, int maxdm, int m,
                                            float cur) {
  float acc = cur;
  int x = m - maxdm;  // maxdm < ml by the packing (ML >= Mp + maxdm + 1)
  if (x < 0) x += ml;
  const int n_dm = 2 * maxdm + 1;
  for (int t = 0; t < n_dm; ++t) {
    const float* w = wrows + static_cast<size_t>(t) * kNdc * ml + x;
#pragma unroll
    for (int u = 0; u < kNdc; ++u) {
      if (page[u] != nullptr) {
        acc = fminf(acc, __fadd_rn(page[u][x], w[static_cast<size_t>(u) * ml]));
      }
    }
    x = (x + 1 == ml) ? 0 : x + 1;
  }
  return acc;
}

}  // namespace band
