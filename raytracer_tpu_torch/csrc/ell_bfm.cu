// One Bellman-Ford-Moore iteration on a padded ELL graph.
//
// A kernel of the port's own choice: the JAX package runs this iteration
// as XLA, the body of one jitted lax.while_loop (raytracer_tpu/ops/
// relax.py bfm_step, raytracer_tpu/solvers/bfm.py), with no Pallas
// kernel.  Python wrapper, tables and plain PyTorch twin:
// raytracer_tpu_torch/ops/relax.py (bfm_step, device_graph, row_degrees,
// bfm_step_reference); the halo groups: ops/graph.halo_by_destination.
//
// What it computes.  S fields side by side, dist0 (S, n_pad) float32 or
// float64 (one template build a type), prev0 (S, n_pad) int32, front0
// (S, n_pad) bytes; nbr (n_pad, K) int32 and w (n_pad, K) the ELL graph,
// deg (n_pad) the slots a row reads (one past its last slot that does not
// point at the row itself).  With active = live_in && it_in < max_iters:
//   relax_merge_kernel, a warp a row i, for each field:
//     1. relax: if active and i is in the frontier, the minimum of
//        dist0[nbr[i,k]] + w[i,k] over k < deg[i], the FIRST slot k on
//        ties (each lane keeps its first strict minimum over k = lane,
//        lane+32, ..., then a shuffle reduction on (value, k)); dist and
//        prev take it where it is strictly below dist0[i].  Slots past
//        deg[i] point at i with weights >= 0 and never improve it, so
//        this is jnp.argmin over all K slots where it matters;
//     2. halo merge, for a halo destination d = i (didx[i] >= 0): its
//        rows' sources s, in table order (hsrc[hoff[g] .. hoff[g+1]]),
//        each relaxed by the same warp as in 1 (the values after the
//        relaxation and before the merge, as the JAX scatter reads them);
//        a row with v_s < dist0[s] and v_d > v_s is a candidate, d takes
//        the least candidate, and of the rows whose candidate equals it
//        the LAST in table order gives prev (the JAX package's .at[].set
//        with repeated indices on the CPU);
//     3. dist1, prev1 and improved = dist1 < dist0.
//   frontier_kernel, a warp a row: front1[i] = improved[i] or
//     improved[nbr[i,k]] for some k < deg[i] (JAX takes all K slots: the
//     padding points at i itself), and mask[i] when a level mask is given
//     (the staged solves' masked step, raytracer_tpu/solvers/
//     multiphase.py _masked_step: the frontier ANDed with the level);
//     live_out = 1 where a front bit is set, so a masked frontier that
//     empties stops the host's loop where the JAX loop stops; it_out =
//     it_in + 1.
// When not active, dist, prev and front are copied through and it_out =
// it_in, live_out = live_in: a step after the frontier empties changes
// nothing, so the host reads live and it every few steps and still counts
// the JAX package's iterations.  Each candidate is one __fadd_rn /
// __dadd_rn and the minimum does not depend on order, so the floats and
// ids are those of the twin.
//
// What bounds it on an H100.  At 180x63 (150,528 rows, K = 1,264, 24.6M
// real slots, mean degree 164, max 1,260) an iteration with the whole
// graph in the frontier reads nbr and w of the real slots once (8 B a
// slot, ~197 MB: ~0.059 ms at 3.35 TB/s) and gathers dist0[nbr], which
// the 50 MB L2 holds (0.6 MB a field); the frontier pass reads nbr again
// (~98 MB).  Rows outside the frontier cost only their copy, so the
// early iterations, with a small frontier, are latency-bound.  The design
// is the simple one: a warp a row, coalesced over the row's slots, the
// field loop outside (nbr and w of a row come from L1/L2 for the second
// field on).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::pos_inf;

constexpr int kWarps = 8;  // rows a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Ctl {
  const int* it_in;
  const int* live_in;
  int max_iters;
  __device__ __forceinline__ bool active() const { return *live_in != 0 && *it_in < max_iters; }
};

// the relaxed (value, prev) of row r: the warp's argmin over its slots
// when r is in the frontier and it beats dist0[r], else (dist0[r],
// prev0[r]); every lane returns the same pair
template <typename T>
__device__ __forceinline__ void relaxed(int r, const T* __restrict__ d0,
                                        const int* __restrict__ p0,
                                        const uint8_t* __restrict__ f0,
                                        const int* __restrict__ nbr, const T* __restrict__ w,
                                        const int* __restrict__ deg, int K, bool active,
                                        int lane, T& v, int& p) {
  const T dr = d0[r];
  v = dr;
  p = p0[r];
  if (!active || !f0[r]) return;
  const size_t row = static_cast<size_t>(r) * K;
  const int dg = deg[r];
  T best = pos_inf<T>();
  int kb = INT_MAX;
  for (int k = lane; k < dg; k += 32) {
    const T c = add_rn(d0[nbr[row + k]], w[row + k]);
    if (c < best) {
      best = c;
      kb = k;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T b2 = __shfl_xor_sync(kFull, best, o);
    const int k2 = __shfl_xor_sync(kFull, kb, o);
    if (b2 < best || (b2 == best && k2 < kb)) {
      best = b2;
      kb = k2;
    }
  }
  if (best < dr) {
    v = best;
    p = nbr[row + kb];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    relax_merge_kernel(const T* __restrict__ dist0, const int* __restrict__ prev0,
                       const uint8_t* __restrict__ front0, const int* __restrict__ nbr,
                       const T* __restrict__ w, const int* __restrict__ deg,
                       const int* __restrict__ didx, const int* __restrict__ hoff,
                       const int* __restrict__ hsrc, Ctl ctl, T* __restrict__ dist1,
                       int* __restrict__ prev1, uint8_t* __restrict__ improved, int S,
                       int n_pad, int K) {
  const int lane = threadIdx.x & 31;
  const long long i64 = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i64 >= n_pad) return;  // the whole warp
  const int i = static_cast<int>(i64);
  const bool active = ctl.active();
  const int g = active ? didx[i] : -1;
  for (int b = 0; b < S; ++b) {
    const size_t base = static_cast<size_t>(b) * n_pad;
    const T* d0 = dist0 + base;
    const int* p0 = prev0 + base;
    const uint8_t* f0 = front0 + base;
    T v;
    int p;
    relaxed(i, d0, p0, f0, nbr, w, deg, K, active, lane, v, p);
    if (g >= 0) {
      const T vd = v;  // dist[d] after the relaxation, before the merge
      T m = vd;
      int pm = p;
      for (int h = hoff[g]; h < hoff[g + 1]; ++h) {
        const int s = hsrc[h];
        T vs;
        int ps;
        relaxed(s, d0, p0, f0, nbr, w, deg, K, active, lane, vs, ps);
        if (vs < d0[s] && vd > vs) {
          if (vs < m) {
            m = vs;
            pm = ps;
          } else if (vs == m) {
            pm = ps;  // the last winning row in table order
          }
        }
      }
      v = m;
      p = pm;
    }
    if (lane == 0) {
      dist1[base + i] = v;
      prev1[base + i] = p;
      improved[base + i] = v < d0[i] ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    frontier_kernel(const uint8_t* __restrict__ improved, const uint8_t* __restrict__ front0,
                    const int* __restrict__ nbr, const int* __restrict__ deg,
                    const uint8_t* __restrict__ mask, Ctl ctl,
                    uint8_t* __restrict__ front1, int* __restrict__ it_out,
                    int* __restrict__ live_out, int S, int n_pad, int K) {
  const bool active = ctl.active();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *it_out = *ctl.it_in + (active ? 1 : 0);
    if (!active) *live_out = *ctl.live_in;
  }
  const int lane = threadIdx.x & 31;
  const long long i64 = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i64 >= n_pad) return;
  const int i = static_cast<int>(i64);
  const size_t row = static_cast<size_t>(i) * K;
  const int dg = deg[i];
  // a row outside the level never joins the frontier: skip its scan
  const bool in_level = mask == nullptr || mask[i] != 0;
  for (int b = 0; b < S; ++b) {
    const size_t base = static_cast<size_t>(b) * n_pad;
    bool f;
    if (!active) {
      f = front0[base + i] != 0;
    } else if (!in_level) {
      f = false;
    } else {
      f = improved[base + i] != 0;
      for (int k0 = 0; !f && k0 < dg; k0 += 32) {
        const int k = k0 + lane;
        const bool hit = k < dg && improved[base + nbr[row + k]] != 0;
        f = __any_sync(kFull, hit);
      }
    }
    if (lane == 0) {
      front1[base + i] = f ? 1 : 0;
      if (active && f) *live_out = 1;
    }
  }
}

template <typename T>
int launch(const void* dist0, const void* prev0, const void* front0, const void* nbr,
           const void* w, const void* deg, const void* didx, const void* hoff, const void* hsrc,
           const void* mask, Ctl ctl, void* dist1, void* prev1, void* improved, void* front1, void* it_out,
           void* live_out, int S, int n_pad, int K, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n_pad) + kWarps - 1) /
                                                kWarps);
  relax_merge_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(dist0), static_cast<const int*>(prev0),
      static_cast<const uint8_t*>(front0), static_cast<const int*>(nbr),
      static_cast<const T*>(w), static_cast<const int*>(deg), static_cast<const int*>(didx),
      static_cast<const int*>(hoff), static_cast<const int*>(hsrc), ctl, static_cast<T*>(dist1),
      static_cast<int*>(prev1), static_cast<uint8_t*>(improved), S, n_pad, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  frontier_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(improved), static_cast<const uint8_t*>(front0),
      static_cast<const int*>(nbr), static_cast<const int*>(deg),
      static_cast<const uint8_t*>(mask), ctl, static_cast<uint8_t*>(front1), static_cast<int*>(it_out), static_cast<int*>(live_out), S,
      n_pad, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one iteration on `stream` (the two kernels above); returns the
// CUDA error as an int (0 when both launches were accepted).  dist0/dist1
// (S, n_pad) float32, or float64 when is_double; prev0/prev1 (S, n_pad)
// int32; front0/front1/improved (S, n_pad) bytes (improved is scratch);
// nbr (n_pad, K) int32, w (n_pad, K) of dist's type; deg and didx (n_pad)
// int32, hoff (D+1) and hsrc int32 (hsrc may be empty); mask (n_pad) bytes, the level mask
// of a staged solve, or null for none; it_in, live_in, it_out, live_out one int32 each,
// live_out zeroed by the caller.  All contiguous device memory.
extern "C" int ell_bfm_step_launch(const void* dist0, const void* prev0, const void* front0,
                                   const void* nbr, const void* w, const void* deg,
                                   const void* didx, const void* hoff, const void* hsrc,
                                   const void* mask, const void* it_in, const void* live_in, void* dist1,
                                   void* prev1, void* improved, void* front1, void* it_out,
                                   void* live_out, int S, int n_pad, int K, int max_iters,
                                   int is_double, void* stream) {
  if (S < 1 || n_pad < 1 || K < 1 || max_iters < 0 || !dist0 || !prev0 || !front0 || !nbr ||
      !w || !deg || !didx || !hoff || !it_in || !live_in || !dist1 || !prev1 ||
      !improved || !front1 || !it_out || !live_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ctl ctl{static_cast<const int*>(it_in), static_cast<const int*>(live_in), max_iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(dist0, prev0, front0, nbr, w, deg, didx, hoff, hsrc, mask,
                                    ctl, dist1, prev1, improved, front1, it_out, live_out, S,
                                    n_pad, K, st)
                   : launch<float>(dist0, prev0, front0, nbr, w, deg, didx, hoff, hsrc, mask,
                                   ctl, dist1, prev1, improved, front1, it_out, live_out, S,
                                   n_pad, K, st);
}
