// Min-plus arithmetic of the port's kernels on non-negative travel times:
// one add a candidate that nvcc cannot contract (__fadd_rn / __dadd_rn;
// products and differences likewise),
// the minimum, +inf, and the minimum across a warp or into memory.  Used
// by witer.cu, titer.cu, diag.cu (with diag_scans.cuh), fused.cu and relax.cu
// (through lane_gather.cuh), rsweep.cu, band.cu, plane3d.cu, ell_bfm.cu and
// banded.cu.
#pragma once

#include <cuda_runtime.h>

namespace minplus {

// dynamic shared memory one H100 block may have (227 KB; kernels.BLOCK_SMEM
// on the host): the launchers refuse a launch that asks for more
constexpr size_t kBlockSmem = 232448;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ bool is_inf(float v) { return isinf(v); }
__device__ __forceinline__ bool is_inf(double v) { return isinf(v); }

// the minimum (the values are non-negative or +inf, never -0, so it is
// the same bits whichever operand comes first); a NaN operand, which
// only a stale shared-memory value that the caller discards can make,
// gives the other one
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// min of non-negative floats (+0 .. +inf): their bit patterns order as
// unsigned integers
__device__ __forceinline__ void atomic_min_nonneg(float* a, float v) {
  atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min_nonneg(double* a, double v) {
  atomicMin(reinterpret_cast<unsigned long long*>(a),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min_of(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace minplus
