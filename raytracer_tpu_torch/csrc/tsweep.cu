// One directional theta-column sweep of the xla sweep engine, one block a
// source.
//
// A kernel of the port's own choice: the JAX package runs this sweep as
// XLA, a sequential lax.scan over the theta columns
// (raytracer_tpu/ops/sweep_theta.py _sweep), with no Pallas kernel.  As
// torch ops one column is some tens of launches, thousands a sweep at
// 180x63, which the theta-sharded solve (parallel/theta_shard.py) runs
// twice a round.  Python wrapper, launch planner and plain PyTorch twin:
// raytracer_tpu_torch/ops/sweep_theta.py (tsweep, tsweep_plan, _sweep).
//
// What it computes.  v (S, nt, ML) of type T (float or double, one
// template build a type).  The columns are visited in order c = 0 .. nt-1
// (forward) or nt-1 .. 0 (reverse); p1 and p2 are the columns processed
// one and two steps before, seeded from carry1 / carry2 ((S, ML), the
// neighbour block's halo columns of the theta-sharded solve) or, when
// those are null, from the field's own last two columns in processing
// order.  For column c, lane m (all lane indices mod ML, jnp.roll's wrap):
//   1. cur = v[c, m], then cur = min(cur, p1[m + d1[i]] + w1[i, m]) for the
//      n1 taps of dc = -1 (forward) or +1 (reverse), and the same from p2
//      for the n2 taps of dc = -+2;
//   2. when col_relax, each dc = 0 tap i in order, a Jacobi update of the
//      whole column: cur[m] = min(cur[m], cur[m + d0[i]] + w0[i, m]); then
//      the chain scans, span by span: cur[m] = min(cur[m], cur[m - s_k] +
//      cfp[k, m]) for every k, then cur[m] = min(cur[m], cur[m + s_k] +
//      cbp[k, m]);
//   3. out[c] = cur, and cur becomes p1, p1 becomes p2.
// Every candidate is one add (add_rn, never contracted) and the minimum is
// exact and does not depend on order, so out is the plain twin's bit for
// bit.
//
// What bounds it on an H100.  The in-column steps are a chain: each of
// the n0 + 2L steps of a column reads the whole column as the previous
// step left it, so a sweep is nt * (n0 + 2L) dependent steps (18,720 at
// 180x63), each a shared-memory round trip and a block-wide barrier.
// The bound (chip_smoke.py, _tsweep_work) is the larger of the bytes (the
// field read and written once, the finite weights once: 1.68 MB at
// 180x63, one source, float32) and the operations (an add and a min a
// finite candidate: 34.9 M, 0.00052 ms at 67 TFLOP/s), far below the
// chain's latency: one step alone (neighbour read, update, write,
// barrier; 896 threads) takes 0.053 us on the card.  The first design
// spent 0.49 us a step: an L2 round trip for its weight row each step and
// an integer `%` a candidate on the chain, and 24 us a column on step 1,
// whose 160 weight loads a lane waited on the L2 a few at a time.
//
// The design (tools/chip_kernel_ab.py --kernels tsweep --breakdown
// measured the choices; PERF.md, PR 20).  Thread-block clusters do not
// pay: a cluster barrier a step costs 0.61-0.66 us.  A ring of weight
// rows filled by TMA bulk copies, a per-thread cp.async ring, a ring of
// registers, the next column's dc = -+2 taps carried by the chain and
// builds whose loops unrolled into tens of thousands of instructions all
// ran slower than this.  So one block a source, and:
//   - a column is R = n1 + n2 + n0 + 2L weight rows, the same every
//     column, run in batches of K rows of one kind (step 1's taps, or
//     in-column steps); each thread loads its lanes of a batch into
//     registers (one coalesced load a row) while it runs the batch
//     before, across column ends, so a batch's loads have the batch's
//     time to land and nothing waits on them row by row;
//   - step 1 reads p1 and p2 from shared memory kept with a halo of H
//     lanes each side (H = the largest dc = -+1, -+2 offset), so a tap
//     needs no wrap; three such columns rotate, the new column written
//     into the one no tap of this column reads;
//   - the in-column steps ping-pong between two column buffers, their
//     offsets reduced mod ML on the host, the wrap one compare;
//   - each thread keeps its lanes' values in registers (LPT lanes a
//     thread, a template build each; K = 8 / LPT rows a batch), and the
//     loops stay small (each kind of batch once, unrolled K times).

//
// The global route (tsweep_global_kernel) takes a column that the design
// above cannot hold: five columns over a block's shared memory, or more
// lanes than 16 a thread for 1,024 threads (ops/sweep_theta.tsweep_plan
// picks it from the shapes).  Still one block a source: p1 and p2 are
// read back from the output (the columns just written), the in-column
// steps ping-pong between two columns of global scratch (S, 2, ML), and a
// block barrier ends each step as before (it orders the block's global
// writes for its own reads); step 1's offsets wrap by a compare each way.
// Correctness first: each step is an L2 round trip.

#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

using minplus::add_rn;
using minplus::min_of;
using minplus::pos_inf;

constexpr int kMaxThreads = 1024;

template <typename T, int LPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    tsweep_kernel(const T* __restrict__ v, T* __restrict__ out, const T* __restrict__ carry1,
                  const T* __restrict__ carry2, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w0,
                  const T* __restrict__ cfp, const T* __restrict__ cbp,
                  const int* __restrict__ offs, int n1, int n2, int n0, int L, int nt, int ML,
                  int H, int reverse, int col_relax) {
  // weight rows a batch (8 beat 16 in float32 on the card)
  constexpr int K = 8 / LPT > 0 ? 8 / LPT : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_t1 = n1 + n2;                  // step 1's taps
  const int S = col_relax ? n0 + 2 * L : 0;  // in-column steps
  const int R = n_t1 + S;                    // weight rows a column
  const int PW = ML + 2 * H;                 // a column with its halos
  const T** wrow = reinterpret_cast<const T**>(smem_raw);  // the rows
  T* A = reinterpret_cast<T*>(smem_raw + static_cast<size_t>(R) * sizeof(T*));
  T* B = A + ML;
  T* P[3] = {B + ML, B + ML + PW, B + ML + 2 * PW};  // p1, p2, free
  int* off = reinterpret_cast<int*>(B + ML + 3 * PW);
  const size_t col = static_cast<size_t>(ML);
  const T* vs = v + static_cast<size_t>(blockIdx.x) * nt * col;
  T* os = out + static_cast<size_t>(blockIdx.x) * nt * col;
  const int nth = blockDim.x;
  const T inf = pos_inf<T>();

#pragma unroll 1
  for (int i = threadIdx.x; i < R; i += nth) {
    off[i] = offs[i];
    int t = i;  // row i: w1, w2, then w0, cfp, cbp
    const T* p;
    if (t < n1) {
      p = w1 + t * col;
    } else if ((t -= n1) < n2) {
      p = w2 + t * col;
    } else if ((t -= n2) < n0) {
      p = w0 + t * col;
    } else {
      t -= n0;
      p = t < L ? cfp + t * col : cbp + (t - L) * col;
    }
    wrow[i] = p;
  }

  int m[LPT];
  bool ok[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    m[l] = threadIdx.x + l * nth;
    ok[l] = m[l] < ML;
  }
  const auto col_of = [&](int k) { return reverse ? nt - 1 - k : k; };
  // lane `lane`'s value x into a column with halos (and its halo copies)
  const auto put = [&](T* Q, int lane, T x) {
    Q[H + lane] = x;
    if (lane < H) Q[H + ML + lane] = x;
    if (lane >= ML - H) Q[lane - (ML - H)] = x;
  };

  // the carry: the neighbour's halo columns, or this field's own wrap
  // columns in processing order (Gauss-Seidel staleness)
  const T* src1 = carry1 ? carry1 + blockIdx.x * col : vs + col_of(nt - 1) * col;
  const T* src2 = carry2 ? carry2 + blockIdx.x * col : vs + col_of(nt - 2) * col;
  T r[LPT], vn[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if (ok[l]) {
      put(P[0], m[l], src1[m[l]]);
      put(P[1], m[l], src2[m[l]]);
    }
    r[l] = ok[l] ? vs[col_of(0) * col + m[l]] : inf;
    vn[l] = ok[l] ? vs[col_of(1) * col + m[l]] : inf;
  }
  __syncthreads();

  // A column's weight rows run in batches of K: step 1's rows [0, n_t1)
  // in nb1 batches, then the in-column steps' rows in nbS.  Each thread
  // holds its lanes of one batch (`cur`) while it loads the next (`nxt`),
  // across column ends.
  const int nb1 = (n_t1 + K - 1) / K, nbS = (S + K - 1) / K, NB = nb1 + nbS;
  T cur[K][LPT], nxt[K][LPT];
  const auto load = [&](T (&w)[K][LPT], int b) {
    const int i0 = b < nb1 ? b * K : n_t1 + (b - nb1) * K;
    const int cnt = min(K, (b < nb1 ? n_t1 : R) - i0);
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (u < cnt) {
        const T* p = wrow[i0 + u];
#pragma unroll
        for (int l = 0; l < LPT; ++l)
          if (ok[l]) w[u][l] = __ldg(p + m[l]);
      }
  };
  const auto next = [&](int k, int b) {  // load the batch after batch b
    if (b + 1 < NB)
      load(nxt, b + 1);
    else if (k + 1 < nt)
      load(nxt, 0);
  };
  const auto advance = [&]() {
#pragma unroll
    for (int u = 0; u < K; ++u)
#pragma unroll
      for (int l = 0; l < LPT; ++l) cur[u][l] = nxt[u][l];
  };
  load(cur, 0);

  T* p1 = P[0];
  T* p2 = P[1];
  T* pn = P[2];
#pragma unroll 1
  for (int k = 0; k < nt; ++k) {
    // 1. the taps of the two columns before
#pragma unroll 1
    for (int b = 0; b < nb1; ++b) {
      next(k, b);
      const int i0 = b * K, cnt = min(K, n_t1 - i0);
#pragma unroll
      for (int u = 0; u < K; ++u)
        if (u < cnt) {
          const int i = i0 + u;
          const T* src = (i < n1 ? p1 : p2) + H + off[i];
#pragma unroll
          for (int l = 0; l < LPT; ++l)
            if (ok[l]) r[l] = min_of(r[l], add_rn(src[m[l]], cur[u][l]));
        }
      advance();
    }
    // the column into A for its chain, or (no chain) it is done
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      if (ok[l]) {
        if (S)
          A[m[l]] = r[l];
        else
          put(pn, m[l], r[l]);
      }
    __syncthreads();
    // 2. the in-column steps, one barrier each; the last writes the
    // column into pn
#pragma unroll 1
    for (int b = 0; b < nbS; ++b) {
      next(k, nb1 + b);
      const int t0 = b * K, cnt = min(K, S - t0);
#pragma unroll
      for (int u = 0; u < K; ++u)
        if (u < cnt) {
          const int t = t0 + u;
          const int d = off[n_t1 + t];
#pragma unroll
          for (int l = 0; l < LPT; ++l)
            if (ok[l]) {
              int j = m[l] + d;
              j = j >= ML ? j - ML : j;
              r[l] = min_of(r[l], add_rn(A[j], cur[u][l]));
              if (t + 1 < S)
                B[m[l]] = r[l];
              else
                put(pn, m[l], r[l]);
            }
          __syncthreads();
          T* tmp = A;
          A = B;
          B = tmp;
        }
      advance();
    }
    // 3. the column out; it is p1 now (in pn), p1 becomes p2
    const size_t c = static_cast<size_t>(col_of(k));
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      if (ok[l]) {
        os[c * col + m[l]] = r[l];
        r[l] = vn[l];
        vn[l] = k + 2 < nt ? vs[col_of(k + 2) * col + m[l]] : inf;
      }
    T* tmp = p2;
    p2 = p1;
    p1 = pn;
    pn = tmp;
  }
}

// The global route: the same sweep with every column in global memory
// (no __restrict__: the kernel reads back what it writes).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tsweep_global_kernel(const T* v, T* out, const T* carry1, const T* carry2, const T* w1,
                         const T* w2, const T* w0, const T* cfp, const T* cbp, const int* offs,
                         T* scratch, int n1, int n2, int n0, int L, int nt, int ML, int reverse,
                         int col_relax) {
  const size_t col = static_cast<size_t>(ML);
  const T* vs = v + static_cast<size_t>(blockIdx.x) * nt * col;
  T* os = out + static_cast<size_t>(blockIdx.x) * nt * col;
  T* A = scratch + static_cast<size_t>(blockIdx.x) * 2 * col;
  T* Bc = A + col;
  const int n_t1 = n1 + n2;
  const int S = col_relax ? n0 + 2 * L : 0;
  const int nth = blockDim.x;
  const auto col_of = [&](int k) { return reverse ? nt - 1 - k : k; };
  const T* src1 = carry1 ? carry1 + blockIdx.x * col : vs + col_of(nt - 1) * col;
  const T* src2 = carry2 ? carry2 + blockIdx.x * col : vs + col_of(nt - 2) * col;
#pragma unroll 1
  for (int k = 0; k < nt; ++k) {
    const size_t c = static_cast<size_t>(col_of(k));
    const T* p1 = k >= 1 ? os + col_of(k - 1) * col : src1;
    const T* p2 = k >= 2 ? os + col_of(k - 2) * col : (k == 1 ? src1 : src2);
    T* dst = S ? A : os + c * col;
    // 1. the taps of the two columns before
    for (int m = threadIdx.x; m < ML; m += nth) {
      T r = vs[c * col + m];
      for (int i = 0; i < n_t1; ++i) {
        int j = m + offs[i];
        j = j < 0 ? j + ML : (j >= ML ? j - ML : j);
        const T* src = i < n1 ? p1 : p2;
        const T* w = i < n1 ? w1 + i * col : w2 + (i - n1) * col;
        r = min_of(r, add_rn(src[j], w[m]));
      }
      dst[m] = r;
    }
    __syncthreads();
    // 2. the in-column steps, a Jacobi update of the column each
    for (int t = 0; t < S; ++t) {
      const T* X = t % 2 == 0 ? A : Bc;
      T* Y = t + 1 == S ? os + c * col : (t % 2 == 0 ? Bc : A);
      const T* w = t < n0 ? w0 + t * col : (t < n0 + L ? cfp + (t - n0) * col
                                                       : cbp + (t - n0 - L) * col);
      const int d = offs[n_t1 + t];
      for (int m = threadIdx.x; m < ML; m += nth) {
        int j = m + d;
        j = j >= ML ? j - ML : j;
        Y[m] = min_of(X[m], add_rn(X[j], w[m]));
      }
      __syncthreads();
    }
  }
}

template <typename T, int LPT>
int launch_lpt(const void* v, void* out, const void* carry1, const void* carry2, const void* w1,
               const void* w2, const void* w0, const void* cfp, const void* cbp,
               const void* offs, int S, int nt, int ML, int n1, int n2, int n0, int L, int H,
               int reverse, int col_relax, int threads, int smem, cudaStream_t st) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      static_cast<long long>(threads) * LPT < ML)
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tsweep_kernel<T, LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  tsweep_kernel<T, LPT><<<S, threads, smem, st>>>(
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<const T*>(carry1),
      static_cast<const T*>(carry2), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w0), static_cast<const T*>(cfp), static_cast<const T*>(cbp),
      static_cast<const int*>(offs), n1, n2, n0, L, nt, ML, H, reverse, col_relax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, void* out, const void* carry1, const void* carry2, const void* w1,
           const void* w2, const void* w0, const void* cfp, const void* cbp, const void* offs,
           int S, int nt, int ML, int n1, int n2, int n0, int L, int H, int reverse,
           int col_relax, int lpt, int threads, int smem, cudaStream_t st) {
  const size_t R = static_cast<size_t>(n1) + n2 + (col_relax ? n0 + 2 * L : 0);
  const size_t need = R * sizeof(T*) +
                      (2 * static_cast<size_t>(ML) + 3 * (static_cast<size_t>(ML) + 2 * H)) *
                          sizeof(T) +
                      4 * R;
  if (H < 0 || H > ML || n1 + n2 < 1 || static_cast<size_t>(smem) != need ||
      need > minplus::kBlockSmem)
    return static_cast<int>(cudaErrorInvalidValue);
#define TSWEEP_LPT(N)                                                                        \
  case N:                                                                                    \
    return launch_lpt<T, N>(v, out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt, ML, n1, \
                            n2, n0, L, H, reverse, col_relax, threads, smem, st);
  switch (lpt) {
    TSWEEP_LPT(1)
    TSWEEP_LPT(2)
    TSWEEP_LPT(4)
    TSWEEP_LPT(8)
    TSWEEP_LPT(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TSWEEP_LPT
}

}  // namespace

// Launches one sweep on `stream`; returns the CUDA error as an int (0 when
// the launch was accepted).  v and out (S, nt, ML), carry1 and carry2 (S,
// ML) or both null, w1 (n1, ML), w2 (n2, ML), w0 (n0, ML), cfp and cbp (L,
// ML): float32, or float64 when is_double; offs int32: the n1 + n2 >= 1
// step-1 offsets as they are (|d| <= H), then, when col_relax, the n0 +
// 2L in-column offsets reduced mod ML (ops/sweep_theta.tsweep_plan); all
// contiguous device memory, out not overlapping v.  One block of
// `threads` threads a source, `lpt` lanes each (1, 2, 4, 8 or 16), with
// `smem` bytes of dynamic shared memory.
extern "C" int tsweep_launch(const void* v, void* out, const void* carry1, const void* carry2,
                             const void* w1, const void* w2, const void* w0, const void* cfp,
                             const void* cbp, const void* offs, int S, int nt, int ML, int n1,
                             int n2, int n0, int L, int H, int reverse, int col_relax, int lpt,
                             int threads, int smem, int is_double, void* stream) {
  if (S < 1 || nt < 2 || ML < 1 || n1 < 0 || n2 < 0 || n0 < 0 || L < 0 ||
      (!carry1) != (!carry2) || static_cast<long long>(nt) * ML > (1LL << 31) - 1 ||
      static_cast<long long>(nt) * (n1 + n2 + n0 + 2 * L) > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(v, out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt,
                                    ML, n1, n2, n0, L, H, reverse, col_relax, lpt, threads, smem,
                                    st)
                   : launch<float>(v, out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt,
                                   ML, n1, n2, n0, L, H, reverse, col_relax, lpt, threads, smem,
                                   st);
}

// Launches one sweep on the global route on `stream`; returns the CUDA
// error as an int.  The arguments as for tsweep_launch (offs the same
// table; no lanes a thread or shared memory), with scratch (S, 2, ML) of
// the field's type when col_relax; `threads` a multiple of 32, 32-1,024.
extern "C" int tsweep_global_launch(const void* v, void* out, const void* carry1,
                                    const void* carry2, const void* w1, const void* w2,
                                    const void* w0, const void* cfp, const void* cbp,
                                    const void* offs, void* scratch, int S, int nt, int ML,
                                    int n1, int n2, int n0, int L, int H, int reverse,
                                    int col_relax, int threads, int is_double, void* stream) {
  if (S < 1 || nt < 2 || ML < 1 || n1 < 0 || n2 < 0 || n1 + n2 < 1 || n0 < 0 || L < 0 ||
      H < 0 || H > ML || (!carry1) != (!carry2) || (col_relax && !scratch) || threads < 32 ||
      threads > kMaxThreads || threads % 32 ||
      static_cast<long long>(nt) * ML > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TSWEEP_GLOBAL(T)                                                                      \
  tsweep_global_kernel<T><<<S, threads, 0, st>>>(                                            \
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<const T*>(carry1),         \
      static_cast<const T*>(carry2), static_cast<const T*>(w1), static_cast<const T*>(w2),   \
      static_cast<const T*>(w0), static_cast<const T*>(cfp), static_cast<const T*>(cbp),     \
      static_cast<const int*>(offs), static_cast<T*>(scratch), n1, n2, n0, L, nt, ML, reverse, \
      col_relax)
  if (is_double)
    TSWEEP_GLOBAL(double);
  else
    TSWEEP_GLOBAL(float);
#undef TSWEEP_GLOBAL
  return static_cast<int>(cudaGetLastError());
}
