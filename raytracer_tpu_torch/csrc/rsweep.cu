// Radial Gauss-Seidel sweep of the T-layout travel-time field.
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/sweep_theta.py
// _make_rsweep_kernel / _rsweep_call.  Python wrapper, host packer and
// plain PyTorch twins: raytracer_tpu_torch/ops/sweep_theta.py (rsweep,
// plan_rsweep, rsweep_reference, rsweep_packed_reference).
//
// What it computes.  buf is (S, MT+K8, NTL) float32 or float64 (one
// template build a type), rows = radial slots,
// lanes = theta columns.  The down sweep holds the field in rows [0, MT)
// with K8 +inf pad rows above it and visits rows MT-1 .. 0 (taps dm > 0);
// the up sweep holds the field in rows [K8, K8+MT) with the pad below and
// visits rows K8 .. K8+MT-1 (taps dm < 0).  For each visited row r and
// lane c:
//     buf[r, c] = min(buf[r, c],
//                     min over taps (buf[r+dm, lane(c, dc)] + wtab[r, iw]))
// where lane(c, dc) = (c+dc) mod NTL when the lane axis is one block
// (NTB == NTL), and when it is split into NTB-wide blocks, c+dc inside
// c's block or else no candidate (+inf): blocks are seam-blind at both
// edges and the solver's seamfix re-applies those edges exactly.  Each
// candidate is one __fadd_rn / __dadd_rn and min does not depend on
// order, so any order of taps and any split of the work gives the same
// floats, in either type.
//
// Far-tap entries.  float32: an int2 (ring offset or packed tap, the
// weight's bits).  float64: an int4 (ring offset or packed tap, 0, the
// weight's low and high 32 bits), so that one 16-byte shared-memory load
// brings a tap's offset and weight together, as one 8-byte load does in
// float32; a separate double array beside the offsets would cost the far
// loop a second load a tap from a second buffer.  In float64 the ring
// and the near table take twice the bytes, so a grid whose float32 ring
// fits in 227 KB may take the device-memory route (plan_rsweep chooses).
//
// What bounds it on an H100.  Not bytes (the 180x63 field and tables are
// under 2 MB) but the dependence chain: row r needs row r+1 (dm = 1), so
// the MT rows (840 at 180x63) are visited one after another by one CTA
// per source and lane block, and every row costs a block barrier.  The
// design follows the TPU kernel's split of the rows into 8-row blocks:
//   - the field rows that a block reads or writes live in shared memory
//     as a ring of K8+16 rows (row r in slot r mod (K8+16)), each slot
//     padded with 4 halo lanes a side that hold the wrapped lanes (one
//     lane block) or +inf (seam-blind blocks), so a lane shift is an
//     offset;
//   - far pass: the taps whose source row lies outside the row's block
//     are final before the block starts.  The host packs, per row, only
//     those whose weight is finite (a +inf weight never wins the min),
//     with their ring offsets, and all 1024 threads take the block's
//     8 x NTB points at once, a warp 32 x LF lanes of one row so that one
//     tap load serves LF lanes;
//   - near chain: the taps inside the block, from a dense per-block table
//     (weights for source row u, distance d, lane shift dc, in sweep
//     order).  Each thread keeps its lanes' 8 rows in registers; once a
//     row is final it is stored, one barrier, and its 5-lane window is
//     loaded once and pushed into the later rows of the block: one
//     barrier and one shared-memory round trip per row;
//   - cp.async brings the next block's original rows, far taps and near
//     table into shared memory while the block runs (the 8 spare ring
//     slots and double-buffered tap buffers make that possible), and the
//     chain writes the final rows back from registers.
// Where the ring and the tap buffers exceed the 227 KB a CTA may hold
// (wide lane blocks), the same passes read and write the field in device
// memory (L1/L2) and the taps from device memory: a shape route chosen
// by the host packer (plan_rsweep), not a fallback.

#include <cuda_runtime.h>

#include <climits>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace {

constexpr int kB = 8;          // rows per block, the TPU kernel's macro-block
constexpr int kInfo = 20;      // ints per block: start, count, far offset x 8, far count x 8, pad
constexpr int kNear = 248;     // floats per block of the near table: (7 u, 7 d, 5 dc), padded
constexpr int kHalo = 4;       // lanes each side of a ring row (2 used; 16-byte aligned rows)

using minplus::add_rn;
using minplus::min_of;
using minplus::pos_inf;

// a far-tap entry of type T: its ring offset (or packed tap) and weight
template <typename T>
struct FarTap;
template <>
struct FarTap<float> {
  using E = int2;
  __device__ __forceinline__ static int off(const E& e) { return e.x; }
  __device__ __forceinline__ static float w(const E& e) { return __int_as_float(e.y); }
};
template <>
struct FarTap<double> {
  using E = int4;
  __device__ __forceinline__ static int off(const E& e) { return e.x; }
  __device__ __forceinline__ static double w(const E& e) { return __hiloint2double(e.w, e.z); }
};

// row[c] = v in a ring row (row points at lane 0), with the wrapped copy
// in the halo when the lane axis is one block
template <typename T>
__device__ __forceinline__ void put(T* row, int c, T v, int ntb, bool blocked) {
  row[c] = v;
  if (!blocked) {
    if (c < 2) row[ntb + c] = v;
    else if (c >= ntb - 2) row[c - ntb] = v;
  }
}

// the far taps e[0..n) of ring row `row` (lane 0) for the L lanes
// c + 32 k: the entry's ring offset of (source slot, lane shift) and
// weight; one entry load serves the thread's L lanes
template <typename T, int L>
__device__ __forceinline__ void relax_row(T* row, const T* ring,
                                          const typename FarTap<T>::E* e, int n,
                                          int c, int ntb, bool blocked) {
  T v[L];
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = row[c + 32 * k];
#pragma unroll 2
  for (int t = 0; t < n; ++t) {
    const typename FarTap<T>::E q = e[t];
    const T w = FarTap<T>::w(q);
    const T* src = ring + FarTap<T>::off(q) + c;
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = min_of(v[k], add_rn(src[32 * k], w));
  }
#pragma unroll
  for (int k = 0; k < L; ++k) put(row, c + 32 * k, v[k], ntb, blocked);
}

__device__ __forceinline__ int block_row(int g, int mt, int k8, int upward) {
  return upward ? k8 + kB * g : mt - kB - kB * g;
}

// local row of sweep position u (0 = visited first)
__device__ __forceinline__ int local_row(int u, int upward) {
  return upward ? u : kB - 1 - u;
}

// LF (LC): lanes per thread in the far pass (near chain); a warp takes
// 32 * LF (32 * LC) lanes of one row.
template <typename T, int LF, int LC>
__global__ void __launch_bounds__(1024)
rsweep_shared(T* buf, const typename FarTap<T>::E* __restrict__ ent,
              const int* __restrict__ binfo, const T* __restrict__ near,
              int mt, int k8, int ntl, int ntb, int upward, int ent_cap) {
  using E = typename FarTap<T>::E;
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = k8 + 2 * kB;
  const int stride = ntb + 2 * kHalo;
  T* ring = reinterpret_cast<T*>(smem_raw);
  E* ebuf = reinterpret_cast<E*>(ring + static_cast<size_t>(R) * stride);
  T* nbuf = reinterpret_cast<T*>(ebuf + 2 * ent_cap);
  int* ibuf = reinterpret_cast<int*>(nbuf + 2 * kNear);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lid = tid & 31, nwarps = nth >> 5;
  const bool blocked = ntb < ntl;
  T* field = buf + static_cast<size_t>(blockIdx.y) * (mt + k8) * ntl +
             static_cast<size_t>(blockIdx.x) * ntb;
  const int nblk = mt / kB;
  const int chunks = ntb / kVec;
  const int far_groups = ntb / (32 * LF);    // warp items per row
  const bool chain = warp < ntb / (32 * LC);  // one item per chain warp
  const int cc = warp * 32 * LC + lid;        // first chain lane

  // block g's far taps, near table and info into buffer g & 1, and its
  // original rows into their ring slots
  auto prefetch = [&](int g, int start, int n) {
    E* dst = ebuf + (g & 1) * ent_cap;
    for (int i = tid; i < n; i += nth) {
      if constexpr (sizeof(E) == 16) cp_async16(dst + i, ent + start + i);
      else cp_async_ca<8>(dst + i, ent + start + i);
    }
    for (int i = tid; i < kNear / kVec; i += nth)
      cp_async16(nbuf + (g & 1) * kNear + kVec * i,
                 near + static_cast<size_t>(g) * kNear + kVec * i);
    if (tid < kInfo / 4)
      cp_async16(ibuf + (g & 1) * kInfo + 4 * tid,
                 binfo + static_cast<size_t>(g) * kInfo + 4 * tid);
    const int first = block_row(g, mt, k8, upward);
    for (int i = tid; i < kB * chunks; i += nth) {
      const int r = first + i / chunks, q = i % chunks;
      cp_async16(ring + (r % R) * stride + kHalo + kVec * q,
                 field + static_cast<size_t>(r) * ntl + kVec * q);
    }
  };

  for (int i = tid; i < R * 2 * kHalo; i += nth) {
    const int row = i / (2 * kHalo), h = i - row * (2 * kHalo);
    ring[row * stride + (h < kHalo ? h : ntb + h)] = pos_inf<T>();
  }
  // the first block and the K8 rows beyond it (its far sources)
  prefetch(0, binfo[0], binfo[1]);
  {
    const int first = upward ? 0 : mt;
    for (int i = tid; i < k8 * chunks; i += nth) {
      const int r = first + i / chunks, q = i % chunks;
      cp_async16(ring + (r % R) * stride + kHalo + kVec * q,
                 field + static_cast<size_t>(r) * ntl + kVec * q);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!blocked) {
    for (int i = tid; i < R * 4; i += nth) {
      T* row = ring + (i / 4) * stride + kHalo;
      const int h = i % 4;
      if (h < 2) row[h - 2] = row[ntb - 2 + h];
      else row[ntb + h - 2] = row[h - 2];
    }
  }
  __syncthreads();

  for (int g = 0; g < nblk; ++g) {
    const int b = block_row(g, mt, k8, upward);
    const int slot0 = b % R;  // b and R are multiples of 8: rows b..b+7 in slots slot0..slot0+7
    const E* eb = ebuf + (g & 1) * ent_cap;
    const T* nt = nbuf + (g & 1) * kNear;
    const int* info = ibuf + (g & 1) * kInfo;
    // the next block's slots were last read by block g-1
    if (g + 1 < nblk)
      prefetch(g + 1, binfo[static_cast<size_t>(g + 1) * kInfo],
               binfo[static_cast<size_t>(g + 1) * kInfo + 1]);

    // far pass: every point of the block against the rows outside it
    for (int it = warp; it < kB * far_groups; it += nwarps) {
      const int j = it / far_groups;
      const int c = (it - j * far_groups) * 32 * LF + lid;
      relax_row<T, LF>(ring + (slot0 + j) * stride + kHalo, ring,
                    eb + info[2 + j], info[10 + j], c, ntb, blocked);
    }
    __syncthreads();

    // near chain in sweep order u = 0..7: v[k][u] is lane cc + 32 k of the
    // row at sweep position u; row u is final once rows 0..u-1 pushed
    T v[LC][kB];
    if (chain) {
#pragma unroll
      for (int u = 0; u < kB; ++u)
#pragma unroll
        for (int k = 0; k < LC; ++k)
          v[k][u] = ring[(slot0 + local_row(u, upward)) * stride + kHalo + cc + 32 * k];
    }
#pragma unroll
    for (int u = 0; u < kB - 1; ++u) {
      T* row = ring + (slot0 + local_row(u, upward)) * stride + kHalo;
      if (u > 0) {
        if (chain) {
#pragma unroll
          for (int k = 0; k < LC; ++k) put(row, cc + 32 * k, v[k][u], ntb, blocked);
        }
        __syncthreads();
      }
      if (chain) {
        T w[LC][5];
#pragma unroll
        for (int k = 0; k < LC; ++k)
#pragma unroll
          for (int t = 0; t < 5; ++t) w[k][t] = row[cc + 32 * k + t - 2];
#pragma unroll
        for (int d = 1; u + d < kB; ++d) {
          const T* p = nt + (u * (kB - 1) + d - 1) * 5;
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            const T wt = p[t];
#pragma unroll
            for (int k = 0; k < LC; ++k)
              v[k][u + d] = min_of(v[k][u + d], add_rn(w[k][t], wt));
          }
        }
      }
    }
    if (chain) {
      T* row = ring + (slot0 + local_row(kB - 1, upward)) * stride + kHalo;
#pragma unroll
      for (int k = 0; k < LC; ++k) put(row, cc + 32 * k, v[k][kB - 1], ntb, blocked);
      // the block's rows are final: write them back
#pragma unroll
      for (int u = 0; u < kB; ++u)
#pragma unroll
        for (int k = 0; k < LC; ++k)
          field[static_cast<size_t>(b + local_row(u, upward)) * ntl + cc + 32 * k] = v[k][u];
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// The same passes with the field in device memory (L1/L2), for lane
// blocks whose ring would not fit; a far entry's tap is (dm << 3) | (dc + 2).
template <typename T>
__global__ void __launch_bounds__(1024)
rsweep_global(T* buf, const typename FarTap<T>::E* __restrict__ ent,
              const int* __restrict__ binfo, const T* __restrict__ near,
              int mt, int k8, int ntl, int ntb, int upward) {
  using E = typename FarTap<T>::E;
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool blocked = ntb < ntl;
  T* field = buf + static_cast<size_t>(blockIdx.y) * (mt + k8) * ntl +
             static_cast<size_t>(blockIdx.x) * ntb;
  const int nblk = mt / kB;
  // source lane of c shifted by dc, or -1 across a block edge
  const auto lane = [&](int c, int dc) {
    int sl = c + dc;
    if (sl < 0 || sl >= ntb) {
      if (blocked) return -1;
      sl += sl < 0 ? ntb : -ntb;
    }
    return sl;
  };
  for (int g = 0; g < nblk; ++g) {
    const int b = block_row(g, mt, k8, upward);
    const int* info = binfo + static_cast<size_t>(g) * kInfo;
    const E* eb = ent + __ldg(&info[0]);
    const T* nt = near + static_cast<size_t>(g) * kNear;
    for (int p = tid; p < kB * ntb; p += nth) {
      const int j = p / ntb, c = p - j * ntb;
      const int r = b + j;
      T* row = field + static_cast<size_t>(r) * ntl;
      const E* e = eb + __ldg(&info[2 + j]);
      const int n = __ldg(&info[10 + j]);
      T v = row[c];
      for (int t = 0; t < n; ++t) {
        const E q = __ldg(&e[t]);
        const int x = FarTap<T>::off(q);
        const int sl = lane(c, (x & 7) - 2);
        if (sl < 0) continue;  // crossed a block edge: +inf candidate
        v = min_of(v, add_rn(field[static_cast<size_t>(r + (x >> 3)) * ntl + sl],
                             FarTap<T>::w(q)));
      }
      row[c] = v;
    }
    __syncthreads();
    for (int u = 1; u < kB; ++u) {
      const int r = b + local_row(u, upward);
      T* row = field + static_cast<size_t>(r) * ntl;
      for (int c = tid; c < ntb; c += nth) {
        T v = row[c];
        for (int us = 0; us < u; ++us) {
          const T* src = field + static_cast<size_t>(b + local_row(us, upward)) * ntl;
          const T* p = nt + (us * (kB - 1) + u - us - 1) * 5;
          for (int t = 0; t < 5; ++t) {
            const int sl = lane(c, t - 2);
            if (sl >= 0) v = min_of(v, add_rn(src[sl], __ldg(&p[t])));
          }
        }
        row[c] = v;
      }
      __syncthreads();
    }
  }
}

template <typename T, int LF, int LC>
int launch_shared(const dim3& grid, int threads, size_t smem, cudaStream_t st,
                  void* buf, const void* ent, const void* binfo,
                  const void* near, int mt, int k8, int ntl, int ntb,
                  int upward, int ent_cap) {
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rsweep_shared<T, LF, LC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  rsweep_shared<T, LF, LC><<<grid, threads, smem, st>>>(
      static_cast<T*>(buf), static_cast<const typename FarTap<T>::E*>(ent),
      static_cast<const int*>(binfo), static_cast<const T*>(near), mt, k8,
      ntl, ntb, upward, ent_cap);
  return 0;
}

template <typename T>
int launch(void* buf, const void* ent, const void* binfo, const void* near,
           int s, int mt, int k8, int ntl, int ntb, int upward,
           int shared_route, int ent_cap, int threads, int far_lanes,
           int near_lanes, cudaStream_t st) {
  const dim3 grid(ntl / ntb, s);
  if (shared_route) {
    const size_t smem =
        static_cast<size_t>(k8 + 2 * kB) * (ntb + 2 * kHalo) * sizeof(T) +
        static_cast<size_t>(2) * ent_cap * sizeof(typename FarTap<T>::E) +
        2 * kNear * sizeof(T) + 2 * kInfo * 4;
    int rc = 0;
#define RSWEEP_CASE(LF, LC)                                                   \
  if (far_lanes == LF && near_lanes == LC)                                    \
    rc = launch_shared<T, LF, LC>(grid, threads, smem, st, buf, ent, binfo,   \
                                  near, mt, k8, ntl, ntb, upward, ent_cap);
    RSWEEP_CASE(4, 1) RSWEEP_CASE(4, 2) RSWEEP_CASE(4, 4) RSWEEP_CASE(2, 1)
#undef RSWEEP_CASE
    if (rc) return rc;
  } else {
    rsweep_global<T><<<grid, threads, 0, st>>>(
        static_cast<T*>(buf), static_cast<const typename FarTap<T>::E*>(ent),
        static_cast<const int*>(binfo), static_cast<const T*>(near), mt, k8,
        ntl, ntb, upward);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the sweep on `stream`; returns the CUDA error as an int (0
// when the launch was accepted).  buf (s, mt+k8, ntl) float32, or float64
// when is_double; ent (E, 2) int32 (float32) or (E, 4) int32 (float64),
// binfo (mt/8, 20) int32 and near (mt/8, 248) in buf's type from
// plan_rsweep for this buffer layout, direction and route; all contiguous
// device memory.  One CTA of `threads` threads per (lane block, source).
// shared_route selects the shared-memory ring (ent_cap = the most far
// taps of one block), where each thread takes far_lanes lanes of a row
// in the far pass and near_lanes in the near chain ((4, 1), (4, 2),
// (4, 4), or (2, 1) for 128-lane blocks; the chain needs ntb <= threads
// * near_lanes).
extern "C" int rsweep_launch(void* buf, const void* ent, const void* binfo,
                             const void* near, int s, int mt, int k8, int ntl,
                             int ntb, int upward, int shared_route,
                             int ent_cap, int threads, int far_lanes,
                             int near_lanes, int is_double, void* stream) {
  const bool lanes_ok =
      far_lanes == 4 ? near_lanes == 1 || near_lanes == 2 || near_lanes == 4
                     : far_lanes == 2 && near_lanes == 1;
  if (s < 1 || s > 65535 || mt < kB || mt % kB || k8 < 0 || k8 % kB ||
      ntb < 128 || ntb % 128 || ntl % ntb || threads < 32 ||
      threads > 1024 || threads % 32 || ent_cap < 1 || !lanes_ok ||
      (shared_route && ntb > threads * near_lanes) ||
      static_cast<long long>(mt + k8) * ntl > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(buf, ent, binfo, near, s, mt, k8, ntl, ntb, upward,
                              shared_route, ent_cap, threads, far_lanes, near_lanes, st)
             : launch<float>(buf, ent, binfo, near, s, mt, k8, ntl, ntb, upward,
                             shared_route, ent_cap, threads, far_lanes, near_lanes, st);
}
