// Predecessor walks and their sensitivity rows: jump tables, then one
// block a receiver.
//
// A kernel of the port's own choice: the JAX package runs this walk as
// XLA, a fixed-depth lax.scan vmapped over the receivers
// (raytracer_tpu/solvers/path.py backtrace_paths) followed by the pair
// terms and scatter of raytracer_tpu/solvers/sensitivity.py _coo_jit /
// _dense_jit, with no Pallas kernel.  Python wrapper and plain PyTorch
// twin: raytracer_tpu_torch/ops/paths.py (paths, paths_reference).
//
// What it computes.  prev (n) int32, receivers (n_rec) int32.  The step
// of a walk is f(a) = a if a == source, else prev[a] if that lies in
// [0, n), else a (a walk that meets an id outside stays where it is), and
// nodes[r, k] = f^k(receivers[r]) for k < max_len (so the row ends in the
// source, repeated).  With coords (ndim, n), U (n) of type T (float or
// double, one template build a type) and partners (n, P) int32, each
// walked pair (a, b) = (nodes[r, k], nodes[r, k+1]) also gives
//   L = sqrt(sum_ax (x_a - x_b)^2),  usum = U_a + U_b,
//   inv = 1/usum unless usum <= 0 or b is one of a's twin partners
//         (a zero-cost halo merge hop), else 0,
//   t_e = (2 L) inv,  g = -(t_e inv),
// written as ids[r, k] = a, ids[r, K + k] = b, vals[r, k] = vals[r, K +
// k] = g (K = max_len - 1).  With dense (n_rec, n), row r holds vals[r, j]
// added at column ids[r, j] for j = 0 .. 2K-1 in order from +0.0 (the
// twin's scatter_add_ order) and zeros elsewhere; the kernel writes the
// whole row.  Every product, sum and difference is one correctly rounded
// operation (__fmul_rn and the like, no contraction into FMAs), sqrt and
// the division are IEEE, so ids are the twin's bit for bit and vals too.
//
// Design.
//   * Jump tables F_j = f^(2^j), j < levels = max(1, bit_length(max_len -
//     1)), in the caller's scratch (levels, n): F_0 in one pass over the
//     nodes, then up to three levels a pass, F_{j+1..j+3} = F_j applied
//     2, 4, 8 times (launches on the same stream: 4 at max_len 972).  nodes[r, k] is then k's binary digits'
//     jumps from receivers[r], at most `levels` dependent gathers, and
//     every (r, k) is independent: the walk's max_len-step chain is gone.
//   * A thread an (r, k): the node, and with the terms its pair (b =
//     F_0[a]) and g, written coalesced.
//   * Dense rows without atomics.  Walk r is a "rho": nodes mu .. K
//     repeat with period lam (the source's tail has lam 1; a cycle of
//     prev, ROADMAP C.9, its length; lam 0 when no node repeats within
//     the row).  Column c of the row gets g[i] (as a, j = i < K) and
//     g[i-1] (as b, j = K + i - 1 >= K) for every position i with
//     nodes[i] == c, so in j order: the a-terms by ascending i, then the
//     b-terms by ascending i.  The matrix is cut into blocks of (a row,
//     a range of kMinWidth to kMaxWidth columns), enough of them for
//     four an SM; each block finds its row's lam (the least p with
//     nodes[K-p] == nodes[K]) and mu (the least i with nodes[i] ==
//     nodes[i+lam]) by two min-reductions; the thread of each first
//     occurrence i < mu + lam whose node lies in its columns sums that
//     column's terms in the order above from +0.0 into shared memory,
//     with a bit a column; then the block writes each of its columns
//     once, its sum or a zero (a sum stored over a zero already written
//     cost as much as all the zeros: the row had left L2, and a partial
//     write is a read of DRAM first).  A node that occurs once is
//     the two terms g[i] + g[i-1]; the source's tail, whose repeated pair
//     (c, c) has g == -0.0 (L = 0), is +0.0 + g[mu-1] exactly (adding a
//     zero to +0.0 or to a negative sum leaves it); a cycle's node sums
//     its ~2 K/lam terms in order.  Two launches on the same inputs give
//     the same bits.
//
// What bounds it on an H100.  The dense rows: n_rec x n values written
// (180 MB at 180x63 with 150 receivers in double), 54 us at 3.35 TB/s;
// the tables, the walks and the COO rows are a few MB.  The jump tables
// cost a few passes over n nodes (L2-resident), a walk `levels`
// dependent L2 gathers a node.  The zeros
// are spread over every SM (a row's 1.2 MB from one SM ran at a fraction
// of the card's write rate, and a block's loads waited behind its own
// stores).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::mul_rn;
using minplus::sub_rn;

constexpr int kThreads = 256;
constexpr int kJumpThreads = 256;
constexpr int kDenseThreads = 256;
constexpr int kMinWidth = 4096;  // columns a dense block fills at least
constexpr int kLevelsALaunch = 3;
constexpr int kStaged = 1024;      // a dense block's column sums held in shared memory
constexpr int kMaxWidth = 32768;   // columns a dense block writes at most
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Terms {
  const T* coords;     // (ndim, n)
  const T* U;          // (n)
  const int* partners; // (n, P)
  int ndim;
  int P;
};

template <typename T>
__device__ __forceinline__ T pair_g(const Terms<T>& tm, int n, int a, int b) {
  T L2 = T(0);
  for (int ax = 0; ax < tm.ndim; ++ax) {
    const T d = sub_rn(tm.coords[static_cast<int64_t>(ax) * n + a],
                       tm.coords[static_cast<int64_t>(ax) * n + b]);
    L2 = ax == 0 ? mul_rn(d, d) : add_rn(L2, mul_rn(d, d));
  }
  const T L = sqrt(L2);
  const T usum = add_rn(tm.U[a], tm.U[b]);
  bool twin = false;
  for (int p = 0; p < tm.P; ++p) twin |= tm.partners[static_cast<int64_t>(a) * tm.P + p] == b;
  const T inv = (usum > T(0) && !twin) ? T(1) / usum : T(0);
  const T te = mul_rn(mul_rn(T(2), L), inv);
  return -mul_rn(te, inv);
}

// F_0 = f over every node
__global__ void __launch_bounds__(kJumpThreads)
    jump0_kernel(const int* __restrict__ prev, int source, int n, int* __restrict__ F0) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n) return;
  int b = a;
  if (a != source) {
    const int p = prev[a];
    b = (p >= 0 && p < n) ? p : a;
  }
  F0[a] = b;
}

// F_{j+1}, ..., F_{j+levels} (levels <= kLevelsALaunch) from F_j alone:
// F_j applied 2, 4, 8 times (8 dependent gathers for three levels, one
// launch where one a level would wait on each launch)
__global__ void __launch_bounds__(kJumpThreads)
    jump_kernel(const int* __restrict__ Fj, int n, int levels, int* __restrict__ out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n) return;
  int x = a;
  for (int l = 0, reps = 2; l < levels; ++l, reps = 1 << l) {
    for (int i = 0; i < reps; ++i) x = Fj[x];
    out[static_cast<int64_t>(l) * n + a] = x;
  }
}

// f^k(x) from the jump tables: one gather a binary digit of k
__device__ __forceinline__ int walk(const int* __restrict__ F, int n, int x, int k) {
  for (int64_t off = 0; k; k >>= 1, off += n)
    if (k & 1) x = F[off + x];
  return x;
}

// the column of position i's node (its first occurrence in the row): the
// a-terms g[i'] (i' < K) then the b-terms g[i'-1] (i' >= 1) over its
// occurrences i' = i, i + lam, ... (only i when lam == 0: a node before
// the repeating part), from +0.0
template <typename T>
__device__ __forceinline__ T column_sum(const T* g, int K, int i, int lam) {
  T s = T(0);
  if (lam == 0) {
    if (i < K) s = add_rn(s, g[i]);
    if (i >= 1) s = add_rn(s, g[i - 1]);
    return s;
  }
  // a fixed point (the source's tail, or an id outside [0, n)): its
  // repeated pair's g is a zero when the coordinates are finite, and a
  // zero added to +0.0 or to a negative sum leaves it
  if (lam == 1 && i < K && g[i] == T(0)) return i >= 1 ? add_rn(s, g[i - 1]) : s;
  for (int j = i; j < K; j += lam) s = add_rn(s, g[j]);
  for (int j = i; j <= K; j += lam)
    if (j >= 1) s = add_rn(s, g[j - 1]);
  return s;
}

// every (r, k) of the walks at once: the node and, with the terms, the
// pair (nodes[r, k], F_0[nodes[r, k]]) and its g
template <typename T>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const int* __restrict__ F, const int* __restrict__ receivers, int n_rec,
                int max_len, int n, int* __restrict__ nodes, Terms<T> tm, int* __restrict__ ids,
                T* __restrict__ vals) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(n_rec) * max_len) return;
  const int r = static_cast<int>(e / max_len), k = static_cast<int>(e % max_len);
  const int K = max_len - 1;
  const int a = walk(F, n, receivers[r], k);
  nodes[e] = a;
  if (ids && k < K) {
    const int b = F[a];
    const T g = pair_g(tm, n, a, b);
    const int64_t row = static_cast<int64_t>(r) * 2 * K;
    ids[row + k] = a;
    ids[row + K + k] = b;
    vals[row + k] = g;
    vals[row + K + k] = g;
  }
}

// The staged sums of a dense block's columns: a bit a column (relative to
// c0) and the (column, sum) pairs.
template <typename T>
struct Staged {
  const unsigned* bits;
  const int* cols;
  const T* vals;
  int n;
};

// the value of column c0 + i: its staged sum, else 0
template <typename T>
__device__ __forceinline__ T column_value(const Staged<T>& sg, int i, int c) {
  if (!((sg.bits[i >> 5] >> (i & 31)) & 1u)) return T(0);
  for (int k = 0; k < sg.n; ++k)
    if (sg.cols[k] == c) return sg.vals[k];
  return T(0);
}

// 16 bytes of T, stored with the streaming hint (st.global.cs: the
// matrix is written once and read by the caller later, so its lines
// should not crowd L2)
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// p[c0 .. c1) written once each, zeros or the staged sums: 16-byte
// streaming stores between a scalar head and tail
template <typename T>
__device__ __forceinline__ void write_columns(T* p, int c0, int c1, const Staged<T>& sg) {
  constexpr int kVec = 16 / sizeof(T);
  const int count = c1 - c0;
  const int head = min(count, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p + c0) & 15)) %
                                               16 / sizeof(T)));
  const int body = (count - head) / kVec;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    __stcs(p + c0 + i, column_value(sg, i, c0 + i));
  for (int k = threadIdx.x; k < body; k += blockDim.x) {
    T w[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int i = head + k * kVec + e;
      w[e] = column_value(sg, i, c0 + i);
    }
    store16(p + c0 + head + k * kVec, w);
  }
  for (int i = head + body * kVec + threadIdx.x; i < count; i += blockDim.x)
    __stcs(p + c0 + i, column_value(sg, i, c0 + i));
}

// columns [c0, c0 + width) of dense row r (block (r, c) of the grid):
// the row's lam and mu from its nodes, the sums of the first occurrences
// whose nodes fall among the columns staged in shared memory, then every
// column written once (8 blocks an SM: the registers stay at 32 a
// thread, so the stores go out from 64 warps an SM)
template <typename T>
__global__ void __launch_bounds__(kDenseThreads, 8)
    dense_kernel(const int* __restrict__ nodes, const T* __restrict__ vals, int max_len, int n,
                 int width, T* __restrict__ dense) {
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * width;
  const int c1 = min(n, c0 + width);
  const int K = max_len - 1;
  const int* nrow = nodes + static_cast<int64_t>(r) * max_len;
  const T* g = vals + static_cast<int64_t>(r) * 2 * K;
  __shared__ int s_lam, s_mu, s_staged;
  __shared__ int s_col[kStaged];
  __shared__ T s_val[kStaged];
  __shared__ unsigned s_bits[kMaxWidth / 32];
  if (threadIdx.x == 0) {
    s_lam = s_mu = INT_MAX;
    s_staged = 0;
  }
  for (int w = threadIdx.x; w < (c1 - c0 + 31) / 32; w += blockDim.x) s_bits[w] = 0u;
  __syncthreads();
  // each thread's first hit is its least; a warp's least, then one
  // shared atomic a warp (a long tail hits in every thread)
  const int last = nrow[K];
  int hit = INT_MAX;
  for (int p = 1 + threadIdx.x; p <= K; p += blockDim.x)
    if (nrow[K - p] == last) {
      hit = p;
      break;
    }
  hit = __reduce_min_sync(kFull, hit);
  if ((threadIdx.x & 31) == 0 && hit != INT_MAX) atomicMin(&s_lam, hit);
  __syncthreads();
  const int lam = s_lam == INT_MAX ? 0 : s_lam;
  if (lam) {
    hit = INT_MAX;
    for (int i = threadIdx.x; i + lam <= K; i += blockDim.x)
      if (nrow[i] == nrow[i + lam]) {
        hit = i;
        break;
      }
    hit = __reduce_min_sync(kFull, hit);
    if ((threadIdx.x & 31) == 0 && hit != INT_MAX) atomicMin(&s_mu, hit);
  }
  __syncthreads();  // mu
  const int mu = lam ? s_mu : K + 1;
  for (int i = threadIdx.x; i < mu + lam && i <= K; i += blockDim.x) {
    const int c = nrow[i];
    if (c >= c0 && c < c1) {
      const T v = column_sum(g, K, i, i >= mu ? lam : 0);
      const int slot = atomicAdd(&s_staged, 1);
      if (slot < kStaged) {
        s_col[slot] = c;
        s_val[slot] = v;
        atomicOr(&s_bits[(c - c0) >> 5], 1u << ((c - c0) & 31));
      }
    }
  }
  __syncthreads();  // the staged sums
  const Staged<T> sg{s_bits, s_col, s_val, min(s_staged, kStaged)};
  T* drow = dense + static_cast<int64_t>(r) * n;
  write_columns(drow, c0, c1, sg);
  if (s_staged > kStaged) {  // more first occurrences than slots: the rest after the zeros
    __syncthreads();
    for (int i = threadIdx.x; i < mu + lam && i <= K; i += blockDim.x) {
      const int c = nrow[i];
      if (c >= c0 && c < c1) drow[c] = column_sum(g, K, i, i >= mu ? lam : 0);
    }
  }
}

int levels_of(int max_len) {
  int lv = 0;
  for (int k = max_len - 1; k; k >>= 1) ++lv;
  return lv > 1 ? lv : 1;
}

template <typename T>
int launch(const void* prev, int source, const void* receivers, int n_rec, int max_len,
           void* nodes, const void* coords, int ndim, int n, const void* U, const void* partners,
           int P, void* ids, void* vals, void* dense, void* jumps, cudaStream_t st) {
  int* F = static_cast<int*>(jumps);
  const unsigned jb = static_cast<unsigned>((n + kJumpThreads - 1) / kJumpThreads);
  jump0_kernel<<<jb, kJumpThreads, 0, st>>>(static_cast<const int*>(prev), source, n, F);
  const int lv = levels_of(max_len);
  for (int j = 0; j + 1 < lv; j += kLevelsALaunch) {
    const int levels = min(kLevelsALaunch, lv - 1 - j);
    jump_kernel<<<jb, kJumpThreads, 0, st>>>(F + static_cast<int64_t>(j) * n, n, levels,
                                              F + static_cast<int64_t>(j + 1) * n);
  }
  const Terms<T> tm{static_cast<const T*>(coords), static_cast<const T*>(U),
                    static_cast<const int*>(partners), ndim, P};
  const int64_t items = static_cast<int64_t>(n_rec) * max_len;
  walk_kernel<T><<<static_cast<unsigned>((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      F, static_cast<const int*>(receivers), n_rec, max_len, n, static_cast<int*>(nodes), tm,
      static_cast<int*>(ids), static_cast<T*>(vals));
  if (dense) {
    // enough column chunks that every SM fills some of the matrix
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int want = (4 * sms + n_rec - 1) / n_rec;
    const int chunks = max((n + kMaxWidth - 1) / kMaxWidth,
                           max(1, min(want, (n + kMinWidth - 1) / kMinWidth)));
    const int width = (n + chunks - 1) / chunks;
    dense_kernel<T><<<dim3(n_rec, chunks), kDenseThreads, 0, st>>>(
        static_cast<const int*>(nodes), static_cast<const T*>(vals), max_len, n, width,
        static_cast<T*>(dense));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one walk of every receiver on `stream` (the jump tables, then
// the rows); returns the CUDA error as an int (0 when the launches were
// accepted).  prev (n) and receivers (n_rec) int32, receivers in [0, n);
// nodes (n_rec, max_len) int32; jumps (levels, n) int32 scratch, levels =
// max(1, bit_length(max_len - 1)) (ops/paths.py jump_levels).  coords (ndim, n), U (n) float32, or float64 when is_double,
// and partners (n, P) int32 give the sensitivity rows: ids (n_rec,
// 2*(max_len-1)) int32 and vals of U's type; dense (n_rec, n) of U's
// type, written whole (nothing needs zeroing), may be null.  With coords
// null only nodes is written (ids, vals and dense are then ignored).  All
// contiguous device memory.
extern "C" int paths_launch(const void* prev, int source, const void* receivers, int n_rec,
                            int max_len, void* nodes, const void* coords, int ndim, int n,
                            const void* U, const void* partners, int P, void* ids, void* vals,
                            void* dense, void* jumps, int is_double, void* stream) {
  if (n_rec < 0 || max_len < 1 || n < 1 || !prev || !receivers || !nodes || !jumps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rec == 0) return 0;
  const bool terms = coords != nullptr;
  if (terms && (ndim < 1 || P < 1 || !U || !partners || !ids || !vals))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!terms) ids = vals = dense = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(prev, source, receivers, n_rec, max_len, nodes, coords, ndim,
                                    n, U, partners, P, ids, vals, dense, jumps, st)
                   : launch<float>(prev, source, receivers, n_rec, max_len, nodes, coords, ndim,
                                   n, U, partners, P, ids, vals, dense, jumps, st);
}
