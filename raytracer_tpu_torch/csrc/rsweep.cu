// Radial Gauss-Seidel sweep of the T-layout travel-time field.
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/sweep_theta.py
// _make_rsweep_kernel / _rsweep_call.  Python wrapper, host packer and
// plain PyTorch twins: raytracer_tpu_torch/ops/sweep_theta.py (rsweep,
// plan_rsweep, rsweep_reference, rsweep_packed_reference).
//
// What it computes.  buf is (S, MT+K8, NTL) float32, rows = radial slots,
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
// candidate is one f32 add and min does not depend on order, so any
// order of taps and any split of the work gives the same floats.
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

namespace {

constexpr int kB = 8;          // rows per block, the TPU kernel's macro-block
constexpr int kInfo = 20;      // ints per block: start, count, far offset x 8, far count x 8, pad
constexpr int kNear = 248;     // floats per block of the near table: (7 u, 7 d, 5 dc), padded
constexpr int kHalo = 4;       // lanes each side of a ring row (2 used; 16-byte aligned rows)

// row[c] = v in a ring row (row points at lane 0), with the wrapped copy
// in the halo when the lane axis is one block
__device__ __forceinline__ void put(float* row, int c, float v, int ntb,
                                    bool blocked) {
  row[c] = v;
  if (!blocked) {
    if (c < 2) row[ntb + c] = v;
    else if (c >= ntb - 2) row[c - ntb] = v;
  }
}

// the far taps e[0..n) of ring row `row` (lane 0) for the L lanes
// c + 32 k: entry .x = ring offset of (source slot, lane shift), .y =
// weight bits; one entry load serves the thread's L lanes
template <int L>
__device__ __forceinline__ void relax_row(float* row, const float* ring,
                                          const int2* e, int n, int c,
                                          int ntb, bool blocked) {
  float v[L];
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = row[c + 32 * k];
#pragma unroll 2
  for (int t = 0; t < n; ++t) {
    const int2 q = e[t];
    const float w = __int_as_float(q.y);
    const float* src = ring + q.x + c;
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = fminf(v[k], __fadd_rn(src[32 * k], w));
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
template <int LF, int LC>
__global__ void __launch_bounds__(1024)
rsweep_shared(float* buf, const int2* __restrict__ ent,
              const int* __restrict__ binfo, const float* __restrict__ near,
              int mt, int k8, int ntl, int ntb, int upward, int ent_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = k8 + 2 * kB;
  const int stride = ntb + 2 * kHalo;
  float* ring = reinterpret_cast<float*>(smem_raw);
  int2* ebuf = reinterpret_cast<int2*>(ring + static_cast<size_t>(R) * stride);
  float* nbuf = reinterpret_cast<float*>(ebuf + 2 * ent_cap);
  int* ibuf = reinterpret_cast<int*>(nbuf + 2 * kNear);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lid = tid & 31, nwarps = nth >> 5;
  const bool blocked = ntb < ntl;
  float* field = buf + static_cast<size_t>(blockIdx.y) * (mt + k8) * ntl +
                 static_cast<size_t>(blockIdx.x) * ntb;
  const int nblk = mt / kB;
  const int chunks = ntb / 4;
  const int far_groups = ntb / (32 * LF);    // warp items per row
  const bool chain = warp < ntb / (32 * LC);  // one item per chain warp
  const int cc = warp * 32 * LC + lid;        // first chain lane

  // block g's far taps, near table and info into buffer g & 1, and its
  // original rows into their ring slots
  auto prefetch = [&](int g, int start, int n) {
    int2* dst = ebuf + (g & 1) * ent_cap;
    for (int i = tid; i < n; i += nth) cp_async_ca<8>(dst + i, ent + start + i);
    for (int i = tid; i < kNear / 4; i += nth)
      cp_async16(nbuf + (g & 1) * kNear + 4 * i,
                 near + static_cast<size_t>(g) * kNear + 4 * i);
    if (tid < kInfo / 4)
      cp_async16(ibuf + (g & 1) * kInfo + 4 * tid,
                 binfo + static_cast<size_t>(g) * kInfo + 4 * tid);
    const int first = block_row(g, mt, k8, upward);
    for (int i = tid; i < kB * chunks; i += nth) {
      const int r = first + i / chunks, q = i % chunks;
      cp_async16(ring + (r % R) * stride + kHalo + 4 * q,
                 field + static_cast<size_t>(r) * ntl + 4 * q);
    }
  };

  for (int i = tid; i < R * 2 * kHalo; i += nth) {
    const int row = i / (2 * kHalo), h = i - row * (2 * kHalo);
    ring[row * stride + (h < kHalo ? h : ntb + h)] = __int_as_float(0x7f800000);
  }
  // the first block and the K8 rows beyond it (its far sources)
  prefetch(0, binfo[0], binfo[1]);
  {
    const int first = upward ? 0 : mt;
    for (int i = tid; i < k8 * chunks; i += nth) {
      const int r = first + i / chunks, q = i % chunks;
      cp_async16(ring + (r % R) * stride + kHalo + 4 * q,
                 field + static_cast<size_t>(r) * ntl + 4 * q);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!blocked) {
    for (int i = tid; i < R * 4; i += nth) {
      float* row = ring + (i / 4) * stride + kHalo;
      const int h = i % 4;
      if (h < 2) row[h - 2] = row[ntb - 2 + h];
      else row[ntb + h - 2] = row[h - 2];
    }
  }
  __syncthreads();

  for (int g = 0; g < nblk; ++g) {
    const int b = block_row(g, mt, k8, upward);
    const int slot0 = b % R;  // b and R are multiples of 8: rows b..b+7 in slots slot0..slot0+7
    const int2* eb = ebuf + (g & 1) * ent_cap;
    const float* nt = nbuf + (g & 1) * kNear;
    const int* info = ibuf + (g & 1) * kInfo;
    // the next block's slots were last read by block g-1
    if (g + 1 < nblk)
      prefetch(g + 1, binfo[static_cast<size_t>(g + 1) * kInfo],
               binfo[static_cast<size_t>(g + 1) * kInfo + 1]);

    // far pass: every point of the block against the rows outside it
    for (int it = warp; it < kB * far_groups; it += nwarps) {
      const int j = it / far_groups;
      const int c = (it - j * far_groups) * 32 * LF + lid;
      relax_row<LF>(ring + (slot0 + j) * stride + kHalo, ring,
                    eb + info[2 + j], info[10 + j], c, ntb, blocked);
    }
    __syncthreads();

    // near chain in sweep order u = 0..7: v[k][u] is lane cc + 32 k of the
    // row at sweep position u; row u is final once rows 0..u-1 pushed
    float v[LC][kB];
    if (chain) {
#pragma unroll
      for (int u = 0; u < kB; ++u)
#pragma unroll
        for (int k = 0; k < LC; ++k)
          v[k][u] = ring[(slot0 + local_row(u, upward)) * stride + kHalo + cc + 32 * k];
    }
#pragma unroll
    for (int u = 0; u < kB - 1; ++u) {
      float* row = ring + (slot0 + local_row(u, upward)) * stride + kHalo;
      if (u > 0) {
        if (chain) {
#pragma unroll
          for (int k = 0; k < LC; ++k) put(row, cc + 32 * k, v[k][u], ntb, blocked);
        }
        __syncthreads();
      }
      if (chain) {
        float w[LC][5];
#pragma unroll
        for (int k = 0; k < LC; ++k)
#pragma unroll
          for (int t = 0; t < 5; ++t) w[k][t] = row[cc + 32 * k + t - 2];
#pragma unroll
        for (int d = 1; u + d < kB; ++d) {
          const float* p = nt + (u * (kB - 1) + d - 1) * 5;
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            const float wt = p[t];
#pragma unroll
            for (int k = 0; k < LC; ++k)
              v[k][u + d] = fminf(v[k][u + d], __fadd_rn(w[k][t], wt));
          }
        }
      }
    }
    if (chain) {
      float* row = ring + (slot0 + local_row(kB - 1, upward)) * stride + kHalo;
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
// blocks whose ring would not fit; far entry .x = (dm << 3) | (dc + 2).
__global__ void __launch_bounds__(1024)
rsweep_global(float* buf, const int2* __restrict__ ent,
              const int* __restrict__ binfo, const float* __restrict__ near,
              int mt, int k8, int ntl, int ntb, int upward) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool blocked = ntb < ntl;
  float* field = buf + static_cast<size_t>(blockIdx.y) * (mt + k8) * ntl +
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
    const int2* eb = ent + __ldg(&info[0]);
    const float* nt = near + static_cast<size_t>(g) * kNear;
    for (int p = tid; p < kB * ntb; p += nth) {
      const int j = p / ntb, c = p - j * ntb;
      const int r = b + j;
      float* row = field + static_cast<size_t>(r) * ntl;
      const int2* e = eb + __ldg(&info[2 + j]);
      const int n = __ldg(&info[10 + j]);
      float v = row[c];
      for (int t = 0; t < n; ++t) {
        const int2 q = __ldg(&e[t]);
        const int sl = lane(c, (q.x & 7) - 2);
        if (sl < 0) continue;  // crossed a block edge: +inf candidate
        v = fminf(v, __fadd_rn(field[static_cast<size_t>(r + (q.x >> 3)) * ntl + sl],
                               __int_as_float(q.y)));
      }
      row[c] = v;
    }
    __syncthreads();
    for (int u = 1; u < kB; ++u) {
      const int r = b + local_row(u, upward);
      float* row = field + static_cast<size_t>(r) * ntl;
      for (int c = tid; c < ntb; c += nth) {
        float v = row[c];
        for (int us = 0; us < u; ++us) {
          const float* src = field + static_cast<size_t>(b + local_row(us, upward)) * ntl;
          const float* p = nt + (us * (kB - 1) + u - us - 1) * 5;
          for (int t = 0; t < 5; ++t) {
            const int sl = lane(c, t - 2);
            if (sl >= 0) v = fminf(v, __fadd_rn(src[sl], __ldg(&p[t])));
          }
        }
        row[c] = v;
      }
      __syncthreads();
    }
  }
}

template <int LF, int LC>
int launch_shared(const dim3& grid, int threads, size_t smem, cudaStream_t st,
                  void* buf, const void* ent, const void* binfo,
                  const void* near, int mt, int k8, int ntl, int ntb,
                  int upward, int ent_cap) {
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rsweep_shared<LF, LC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  rsweep_shared<LF, LC><<<grid, threads, smem, st>>>(
      static_cast<float*>(buf), static_cast<const int2*>(ent),
      static_cast<const int*>(binfo), static_cast<const float*>(near), mt, k8,
      ntl, ntb, upward, ent_cap);
  return 0;
}

}  // namespace

// Launches the sweep on `stream`; returns the CUDA error as an int (0
// when the launch was accepted).  buf (s, mt+k8, ntl) float32; ent (E, 2)
// int32, binfo (mt/8, 20) int32 and near (mt/8, 248) float32 from
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
                             int near_lanes, void* stream) {
  const bool lanes_ok =
      far_lanes == 4 ? near_lanes == 1 || near_lanes == 2 || near_lanes == 4
                     : far_lanes == 2 && near_lanes == 1;
  if (s < 1 || s > 65535 || mt < kB || mt % kB || k8 < 0 || k8 % kB ||
      ntb < 128 || ntb % 128 || ntl % ntb || threads < 32 ||
      threads > 1024 || threads % 32 || ent_cap < 1 || !lanes_ok ||
      (shared_route && ntb > threads * near_lanes) ||
      static_cast<long long>(mt + k8) * ntl > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ntl / ntb, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared_route) {
    const size_t smem =
        static_cast<size_t>(k8 + 2 * kB) * (ntb + 2 * kHalo) * 4 +
        static_cast<size_t>(2) * ent_cap * 8 + 2 * kNear * 4 + 2 * kInfo * 4;
    int rc = 0;
#define RSWEEP_CASE(LF, LC)                                                   \
  if (far_lanes == LF && near_lanes == LC)                                    \
    rc = launch_shared<LF, LC>(grid, threads, smem, st, buf, ent, binfo,      \
                               near, mt, k8, ntl, ntb, upward, ent_cap);
    RSWEEP_CASE(4, 1) RSWEEP_CASE(4, 2) RSWEEP_CASE(4, 4) RSWEEP_CASE(2, 1)
#undef RSWEEP_CASE
    if (rc) return rc;
  } else {
    rsweep_global<<<grid, threads, 0, st>>>(
        static_cast<float*>(buf), static_cast<const int2*>(ent),
        static_cast<const int*>(binfo), static_cast<const float*>(near), mt,
        k8, ntl, ntb, upward);
  }
  return static_cast<int>(cudaGetLastError());
}
