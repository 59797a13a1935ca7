// The lane-gather relaxation of the circulant stencil by chunk items,
// shared by csrc/relax.cu (one sweep a launch, the 'pallas' engine) and
// csrc/fused.cu (phase C of the whole-solve kernel, the 'fused' engine).
//
// The state is (T, SR, 128) with SR = S * ntp rows, source-major: row
// r = s * ntp + c holds theta column c of source s, and rows c >= nt
// (ntp is nt rounded up to a multiple of 8) are padding.  One relaxation
// is, for every real row,
//
//   dst[t, r, l] = min(dst[t, r, l], min over the stencil rows k of
//                      tile t of src[st_k, s * ntp + (c + dc_k) mod nt,
//                                    idx[k, l]] + w[k, l])
//
// where dst already holds the value to relax (relax.cu: the input's real
// rows; fused.cu: the scanned state).  The host packs the stencil rows
// into chunks (fused_circulant.relax_chunks): chunk j holds at most kChunk
// rows of one tile t, one kSlab-lane slab and one source tile st, dc = 0
// rows first.  An item is (source, block of kRowBlock theta rows, chunk);
// block b takes an equal run of the item list.  Its kThreads threads take
// an item as kWarps warps x 32 lanes, kRowsPerThread rows a thread, so a
// weight and an index serve kRowsPerThread gathers, each at a constant
// offset.  The item's source window (kRowBlock + 2 * kHalo theta rows
// with the wrapped rows nt-2, nt-1 before and 0, 1 after the nt real
// ones) and its chunk tables come into shared memory by cp.async, double
// buffered; the window is reloaded only when it changes along the run.
// Items of one tile combine by atomicMin on the bits of non-negative
// floats (their order is the integers'): exact and order-free.  Each
// candidate is one add and the minimum does not depend on order, so the
// result is the plain versions' and the Pallas kernel's to the bit.
//
// The two callers differ in three places (Args::kFused):
//   window : fused.cu copies it from its haloed `src` ((T, S, ntp + 4,
//            128), the wrapped rows written by its chain phase); relax.cu
//            copies each window row from the state row it stands for, so
//            the theta wrap is done in the staging;
//   pad rows: fused.cu relaxes them over the dc = 0 rows (the Pallas
//            kernel's dc = 0 copy keeps them); relax.cu leaves them at the
//            +inf its init wrote;
//   centre : fused.cu folds the real rows' partial minima + fan_w into
//            the centre.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "minplus.cuh"

namespace lane_gather {

using minplus::add_rn;
using minplus::atomic_min_nonneg;
using minplus::is_inf;
using minplus::min_of;
using minplus::pos_inf;
using minplus::warp_min;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the chunk tables' format and the work partition:
// fused_circulant.SLAB, CHUNK, WARPS and ROW_BLOCK hold the same values
constexpr int kSlab = 32;           // lanes of an item (a warp)
constexpr int kSlabs = kLanes / kSlab;
constexpr int kChunk = 32;          // most stencil rows in a chunk
constexpr int kRowsPerThread = 8;   // theta rows of a thread in an item
constexpr int kRowBlock = kWarps * kRowsPerThread;
constexpr int kHalo = 2;            // wrapped theta rows each side of a window

// an item's staging: the source window and the chunk's indices, rows and
// weights
template <typename T>
__host__ __device__ constexpr int window_bytes() {
  return (kRowBlock + 2 * kHalo) * kLanes * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int chunk_bytes() {
  return kChunk * kSlab * 4 + kChunk * 4 + kChunk * kSlab * static_cast<int>(sizeof(T));
}

// item -> (chunk, source, row block): the chunk runs fastest, so a
// block's run of items mostly shares one source window (the host orders
// the chunks by source tile)
struct Item {
  int ch, s, rb;
};
__device__ __forceinline__ Item decode_item(int item, int n_chunks, int nrb) {
  const int rest = item / n_chunks;
  return {item - rest * n_chunks, rest / nrb, rest % nrb};
}

// block b takes items [item_run(items, b), item_run(items, b + 1)): an
// equal share of the list
__device__ __forceinline__ int item_run(int items, int b) {
  return static_cast<int>(static_cast<long long>(items) * b / gridDim.x);
}

__host__ __device__ __forceinline__ int relax_items(int n_chunks, int s_count, int ntp) {
  return n_chunks * s_count * ((ntp + kRowBlock - 1) / kRowBlock);
}

// the state row that row h of a source's haloed theta axis stands for:
// nt-2, nt-1, then the nt real rows, then 0, 1, then the pad rows
__device__ __forceinline__ int halo_row(int h, int nt) {
  return h < kHalo ? nt - kHalo + h
                   : (h < nt + kHalo ? h - kHalo : (h < nt + 2 * kHalo ? h - nt - kHalo
                                                                         : h - 2 * kHalo));
}

// cp.async chunk ch's indices, rows and weights into `buf` (no commit)
template <typename T, typename A>
__device__ __forceinline__ void stage_chunk(const A& a, int ch, unsigned char* buf) {
  int* si = reinterpret_cast<int*>(buf);
  int* sr = si + kChunk * kSlab;
  unsigned char* sw = reinterpret_cast<unsigned char*>(sr + kChunk);
  const int* gi = a.ck_idx + static_cast<size_t>(ch) * kChunk * kSlab;
  const int* gr = a.ck_row + static_cast<size_t>(ch) * kChunk;
  const unsigned char* gw = reinterpret_cast<const unsigned char*>(
      a.ck_w + static_cast<size_t>(ch) * kChunk * kSlab);
  for (int i = threadIdx.x; i < kChunk * kSlab / 4; i += blockDim.x)
    cp_async16(si + 4 * i, gi + 4 * i);
  if (threadIdx.x < kChunk / 4) cp_async16(sr + 4 * threadIdx.x, gr + 4 * threadIdx.x);
  constexpr int wv = kChunk * kSlab * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < wv; i += blockDim.x) cp_async16(sw + 16 * i, gw + 16 * i);
}

// the source window of item `it`: source tile, source, row block
template <typename A>
__device__ __forceinline__ int window_key(const A& a, Item it, int nrb) {
  return ((__ldg(a.ck_info + 2 * it.ch) >> 16) * a.s_count + it.s) * nrb + it.rb;
}

// cp.async item `it`'s source window into `buf` (no commit): rows q0 ..
// q0 + kRowBlock + 2 * kHalo - 1 of the haloed theta axis of source
// `it.s` in source tile st
template <typename T, typename A>
__device__ __forceinline__ void stage_window(const A& a, Item it, unsigned char* buf) {
  const int nt = a.nt, ntp = a.ntp, nth = ntp + 2 * kHalo;
  const int st = __ldg(a.ck_info + 2 * it.ch) >> 16;
  const int q0 = it.rb * kRowBlock;
  const int rows = min(kRowBlock + 2 * kHalo, nth - q0);
  constexpr int kPer = kLanes * static_cast<int>(sizeof(T)) / 16;  // copies a row
  if constexpr (A::kFused) {
    const size_t tileh = static_cast<size_t>(a.s_count) * nth * kLanes;
    const unsigned char* gs = reinterpret_cast<const unsigned char*>(
        a.src + st * tileh + (static_cast<size_t>(it.s) * nth + q0) * kLanes);
    for (int i = threadIdx.x; i < rows * kPer; i += blockDim.x)
      cp_async16(buf + 16 * i, gs + 16 * i);
  } else {
    const size_t tile = static_cast<size_t>(a.s_count) * ntp * kLanes;
    const unsigned char* gs = reinterpret_cast<const unsigned char*>(
        a.src + st * tile + static_cast<size_t>(it.s) * ntp * kLanes);
    for (int i = threadIdx.x; i < rows * kPer; i += blockDim.x) {
      const int j = i / kPer;
      const int row = halo_row(q0 + j, nt);
      cp_async16(buf + 16 * i, gs + (static_cast<size_t>(row) * kPer + (i - j * kPer)) * 16);
    }
  }
}

// Relax the state into `dst` ((T, SR, 128)) by this block's run of
// items.  `region` holds two windows, `chunks` two chunk buffers; with
// `first_staged` the run's first chunk is already on its way into
// chunks[0] (committed, not waited for).
template <typename T, typename A>
__device__ void relax_run(const A& a, T* dst, unsigned char* region, unsigned char* chunks,
                          bool first_staged) {
  const int nt = a.nt, ntp = a.ntp;
  const int sr = a.s_count * ntp;
  const int nrb = (ntp + kRowBlock - 1) / kRowBlock;
  const int items = relax_items(a.n_chunks, a.s_count, ntp);
  const size_t tile = static_cast<size_t>(sr) * kLanes;
  const int ls = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lo = item_run(items, blockIdx.x);
  const int hi = item_run(items, blockIdx.x + 1);
  // two window buffers; a block restages only when the window changes
  int cur = 0, cur_key = -1, other_key = -1;
  if (lo < hi) {
    const Item f = decode_item(lo, a.n_chunks, nrb);
    cur_key = window_key(a, f, nrb);
    stage_window<T>(a, f, region);
    if (!first_staged) stage_chunk<T>(a, f.ch, chunks);
    cp_async_commit();
  }
  for (int item = lo, j = 0; item < hi; ++item, ++j) {
    cp_async_wait_all();
    __syncthreads();  // this item's window and chunk are in; the last item is done
    int nxt = cur;
    if (item + 1 < hi) {
      const Item nx = decode_item(item + 1, a.n_chunks, nrb);
      const int nkey = window_key(a, nx, nrb);
      if (nkey != cur_key) {
        nxt = cur ^ 1;
        other_key = nkey;
        stage_window<T>(a, nx, region + nxt * window_bytes<T>());
      }
      stage_chunk<T>(a, nx.ch, chunks + ((j + 1) & 1) * chunk_bytes<T>());
      cp_async_commit();
    }
    const T* win = reinterpret_cast<const T*>(region + cur * window_bytes<T>());
    if (nxt != cur) {
      const int k = cur_key;
      cur_key = other_key;
      other_key = k;
      cur = nxt;
    }
    const int* si = reinterpret_cast<const int*>(chunks + (j & 1) * chunk_bytes<T>());
    const int* srow = si + kChunk * kSlab;
    const T* sw = reinterpret_cast<const T*>(srow + kChunk);

    const Item it = decode_item(item, a.n_chunks, nrb);
    const int s = it.s;
    const int tg = __ldg(a.ck_info + 2 * it.ch) & 0xffff;
    const int nz = __ldg(a.ck_info + 2 * it.ch + 1);
    const int nk = nz & 0xffff;  // rows; the first nz >> 16 have dc = 0
    const int t = tg / kSlabs;
    const int lane = (tg % kSlabs) * kSlab + ls;
    const int q0 = it.rb * kRowBlock;
    const int c0 = q0 + warp;  // rows c0 + kWarps * i
    // real rows: row c, copy dc sits at window row c - q0 + kHalo + dc,
    // so row i is a constant offset from row 0.  Every row is read (the
    // window holds kRowBlock + 2 * kHalo rows); rows past nt, which may
    // read stale window rows, are redone or dropped below.
    T acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = pos_inf<T>();
    const T* wrow = win + (warp + kHalo) * kLanes;
    for (int k = 0; k < nk; ++k) {
      const T wv = sw[k * kSlab + ls];
      const T* base = wrow + ((srow[k] >> 16) - kHalo) * kLanes + si[k * kSlab + ls];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = min_of(acc[i], add_rn(base[i * kWarps * kLanes], wv));
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (c0 + kWarps * i >= nt) acc[i] = pos_inf<T>();
    if constexpr (A::kFused) {
      // pad rows (nt <= c < ntp) take only the dc = 0 rows, from their
      // own row, which sits 2 * kHalo down in src
      bool pad = false;  // the same for the whole warp
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int c = c0 + kWarps * i;
        pad |= c >= nt && c < ntp;
      }
      if (pad) {
        for (int k = 0; k < (nz >> 16); ++k) {
          const T wv = sw[k * kSlab + ls];
          const T* base = win + (warp + 2 * kHalo) * kLanes + si[k * kSlab + ls];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int c = c0 + kWarps * i;
            if (c >= nt && c < ntp)
              acc[i] = min_of(acc[i], add_rn(base[i * kWarps * kLanes], wv));
          }
        }
      }
    }
    T cmin = pos_inf<T>();
    T fw = pos_inf<T>();
    if constexpr (A::kFused) fw = a.fan_w[t * kLanes + lane];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int c = c0 + kWarps * i;
      if (c < ntp && !is_inf(acc[i])) {
        atomic_min_nonneg(dst + t * tile + (static_cast<size_t>(s) * ntp + c) * kLanes + lane,
                          acc[i]);
        if (A::kFused && c < nt && !is_inf(fw)) cmin = min_of(cmin, add_rn(acc[i], fw));
      }
    }
    if constexpr (A::kFused) {
      cmin = warp_min(cmin);
      if (ls == 0 && !is_inf(cmin)) atomic_min_nonneg(a.cen + s, cmin);
    }
  }
}

}  // namespace lane_gather
