// The bipartite AMG smoother of a Newton system for Hopper (sm_90a): all
// the sweeps of one smoothing call in one launch.
//
// Replaces XLA's fusion of otamg/amg/hierarchy.py::_projected_smooth_bip
// (no Pallas kernel: two lax.fori_loops of jnp code), the fine level's
// block Gauss-Seidel sweeps with per-component kernel projection, which
// run twice in every AMG cycle.  Its torch-op form
// (otamg_torch/amg/kernels.py::bip_smooth_plain) is ~39 launches a sweep
// on vectors of 500-2,000 values, so the call was launch-bound.
//
// Nodes: columns j = 0..n-1 (the q side), then rows n + i, i = 0..m-1 (the
// p side); A = diag(g) - itk [[0, E^T], [E, 0]] with E the (m, n) matrix.
// The carried products p = [w; u] = [E^T e2; E e1] make every residual
// gg = r - g e + itk p local.  A sweep (non-transposed order; transposed:
// the two halves swap, E^T d2 first):
//   not deflated: xig = segment sums of gg xi;  c = nsp ? xig[lab] / xx : 0
//                 d1 = (gg1 - Axi1 c1) / g1;  t = E d1
//                 d2 = (gg2 - Axi2 c2 + itk t) / g2;  tw = E^T d2
//                 e += xi c + d;  w += c1 Etxi2 + tw;  u += c2 Exi1 + t
//   deflated:     d from gg as above with c = 0;  e += d;  w += tw; u += t
//                 mean = segment sums of e xi / count;  m = nsp ? mean : 0
//                 e -= xi m;  w -= m1 Etxi2;  u -= m2 Exi1
// Three points of a sweep need every row done: the segment sums, t (d2
// needs all of it in the transposed order, d1 all of d2) and tw.
//
// Bound: bytes.  E is read twice a sweep (E d1, E^T d2), 2 smoth_it m n
// values, and the vectors once; the products are 4 smoth_it m n
// operations, far below the card's rate.  At 500^2 f64, 5 sweeps, E is
// 2.0 MB and the call's bytes ~20 MB: ~6 us at 3.35 TB/s.  What the
// torch-op form paid was ~195 launches a call; here the floor is the
// cluster barriers: one a sweep (non-transposed), two (transposed).
//
// Design:
// * One thread-block cluster of 16 blocks of 512 threads.  Block b owns
//   rows [b R, b R + R) of E (R = ceil(m / 16); kernels.py::
//   bip_smooth_layout): layout 0 copies its panel into its shared memory
//   once a call (500^2 in f64 and f32), layouts 1 and 2 read it from
//   global memory (L2: 1024^2 f64 is 8.4 MB).
// * Every block keeps the whole state (e, p, d, the segment sums) and
//   does all the O(n + m) work itself, in the same order, so every block
//   holds the same bits and only the two products are split.  E d1 is
//   row-local: block b computes t over its rows, a warp a row (lanes over
//   the columns, then a butterfly of shuffles).  E^T d2 is summed over
//   rows: block b sums its rows' share of every column (a thread a
//   column, rows in order), and after a cluster barrier every block adds
//   the 16 shares in block order, read from the peers' shared memory.
//   The rows' t (and d2) are read from their owner the same way.
// * The exchanged values (the shares and the rows' t, d2) alternate
//   between two buffers, so a block that starts the next exchange writes
//   into none that a slower peer still reads: one barrier an exchange.
// * Segment sums: the level's pair plan (positions sorted by component,
//   offsets of each run) is scanned by the block in fixed order: each
//   thread sums a chunk of K = ceil(L / 512) positions sequentially, a
//   segmented scan of the 512 chunk sums (shuffles, then the 16 warp
//   sums) gives each chunk the sum carried into it, and a segment's total
//   is its last position's prefix.  No atomics anywhere: a call gives the
//   same bits on every run, captured or not.
// * Layout 2 (the state past a block's shared memory, N past ~4,000 in
//   f64) keeps each block's state in a global workspace of its own; the
//   peers' buffers are read past L1 (ld.global.cg) after a fence.
//
// C interface, loaded with ctypes: bip_smooth_launch takes its arguments
// packed in one int64 array, launches on the given stream and device, does
// not synchronise and returns cudaGetLastError() or one of the codes
// below.  Where it is given a counter, block 0 adds 1 to it at each run
// (an integer add: graph replays and conditional bodies that run count
// too; the results do not depend on it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 16;  // the cluster
constexpr int kMaxDevices = 64;
constexpr int kBadLayout = -1;
constexpr int kNoCluster = -2;
constexpr int kBadDtype = -3;

struct Args {
  const void* E;      // (m, n)
  const void* g;      // (N,)
  const void* r;      // (N,)
  const void* e;      // (N,), null where e_is_zero
  const void* itk;    // 0-d
  const int64_t* labels;
  const bool* nsp;
  const void* Axi;    // (N,)
  const void* xx;     // (N,)
  const void* Exi1;   // (m,)
  const void* Etxi2;  // (n,)
  const int32_t* order;    // (N,) the pair plan's positions
  const int32_t* offsets;  // (nseg + 1,)
  void* out;               // (N,)
  unsigned char* ws;       // layout 2: the blocks' states
  unsigned long long* runs;  // the kernel's runs on the card, or null
  int m;
  int n;
  int nseg;
  int sweeps;
  int rows;  // R
  int transpose;
  int deflated;
  int e_is_zero;
  int64_t state_bytes;  // a block's state
};

// A block's state, in values of T unless said (kernels.py::
// bip_smooth_layout counts the same): e, p, d, sc (N each), tot, cnt
// (nseg each), part (2 n), rowv (2 x 2 R), carry (512), wtot (16); then
// wflag (16 ints) and flag (N bytes).
template <typename T>
struct State {
  T* e;
  T* p;
  T* d;
  T* sc;
  T* tot;
  T* cnt;
  T* part;  // [2][n]
  T* rowv;  // [2][2][R]
  T* carry;
  T* wtot;
  int* wflag;
  unsigned char* flag;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t state_bytes(int m, int n, int nseg,
                                              int rows, size_t item) {
  const size_t N = static_cast<size_t>(n) + m;
  const size_t vals = 4 * N + 2 * static_cast<size_t>(nseg) + 2 * n +
                      4 * static_cast<size_t>(rows) + kThreads + kWarps;
  return align16(align16(vals * item) + 4 * kWarps + N);
}

template <typename T>
__device__ State<T> carve(unsigned char* base, int m, int n, int nseg,
                          int rows) {
  const int N = n + m;
  State<T> s;
  T* v = reinterpret_cast<T*>(base);
  s.e = v;
  s.p = s.e + N;
  s.d = s.p + N;
  s.sc = s.d + N;
  s.tot = s.sc + N;
  s.cnt = s.tot + nseg;
  s.part = s.cnt + nseg;
  s.rowv = s.part + 2 * n;
  s.carry = s.rowv + 4 * rows;
  s.wtot = s.carry + kThreads;
  unsigned char* rest = base + align16(
      reinterpret_cast<unsigned char*>(s.wtot + kWarps) - base);
  s.wflag = reinterpret_cast<int*>(rest);
  s.flag = rest + 4 * kWarps;
  return s;
}

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return __ldg(static_cast<const T*>(p) + i);
}

// A value of a peer's exchange buffer: its shared memory (layouts 0, 1) or
// its state in the workspace (layout 2; past L1, written by another SM).
template <typename T, bool kGlobalState>
__device__ __forceinline__ T peer_ld(const T* mine, int b, int me,
                                     int64_t stride_vals, int i) {
  if (kGlobalState) {
    return __ldcg(mine + static_cast<int64_t>(b - me) * stride_vals + i);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    return cluster.map_shared_rank(const_cast<T*>(mine), b)[i];
  }
}

template <bool kGlobalState>
__device__ __forceinline__ void exchange() {
  if (kGlobalState) __threadfence();
  cg::this_cluster().sync();
}

// Segment sums of val(k) over the plan into tot[0..nseg): the chunked
// segmented scan described at the top, the same order in every block.
template <typename T, typename F>
__device__ void segment_sums(const Args& a, const State<T>& s, int L, F val) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = L > 0 ? (L + kThreads - 1) / kThreads : 1;
  const int q0 = min(L, tid * K), q1 = min(L, q0 + K);
  T acc = T(0);
  int f = 0;
  for (int q = q0; q < q1; ++q) {
    if (s.flag[q]) {
      acc = T(0);
      f = 1;
    }
    acc += val(a.order[q]);
    s.sc[q] = acc;
  }
  // Inclusive segmented scan of the chunks' (f, acc): within the warp...
  for (int o = 1; o < 32; o <<= 1) {
    const T vo = __shfl_up_sync(kFull, acc, o);
    const int fo = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) acc = vo + acc;
      f |= fo;
    }
  }
  if (lane == 31) {
    s.wtot[warp] = acc;
    s.wflag[warp] = f;
  }
  __syncthreads();
  // ... then over the warps' sums ...
  if (warp == 0) {
    T v = lane < kWarps ? s.wtot[lane] : T(0);
    int wf = lane < kWarps ? s.wflag[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const T vo = __shfl_up_sync(kFull, v, o);
      const int fo = __shfl_up_sync(kFull, wf, o);
      if (lane >= o) {
        if (!wf) v = vo + v;
        wf |= fo;
      }
    }
    if (lane < kWarps) {
      s.wtot[lane] = v;
      s.wflag[lane] = wf;
    }
  }
  __syncthreads();
  // ... and the sum carried into each chunk (the previous chunk's).
  if (warp > 0 && !f) acc = s.wtot[warp - 1] + acc;
  T prev = __shfl_up_sync(kFull, acc, 1);
  if (lane == 0) prev = warp > 0 ? s.wtot[warp - 1] : T(0);
  s.carry[tid] = prev;
  __syncthreads();
  for (int seg = tid; seg < a.nseg; seg += kThreads) {
    const int lo = a.offsets[seg], hi = a.offsets[seg + 1];
    T v = T(0);
    if (lo < hi) {
      const int q = hi - 1, t = q / K;
      v = lo >= t * K ? s.sc[q] : s.carry[t] + s.sc[q];
    }
    s.tot[seg] = v;
  }
  __syncthreads();
}

// Row i's product with x (a warp; the same bits in every lane).
template <typename T>
__device__ __forceinline__ T row_dot(const T* row, const T* x, int n,
                                     int lane) {
  T acc = T(0);
  for (int j = lane; j < n; j += 32) acc += row[j] * x[j];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

template <typename T, bool kSharedE, bool kGlobalState>
__global__ void __launch_bounds__(kThreads) bip_smooth_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m, n = a.n, N = n + m, R = a.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int me = blockIdx.x;  // the grid is one cluster
  const int r0 = min(m, me * R), r1 = min(m, r0 + R);
  const size_t panel = kSharedE ? static_cast<size_t>(R) * n * sizeof(T)
                                : 0;
  unsigned char* base =
      kGlobalState ? a.ws + static_cast<size_t>(me) * a.state_bytes
                   : smem + align16(panel);
  const State<T> s = carve<T>(base, m, n, a.nseg, R);
  const int64_t stride = a.state_bytes / static_cast<int64_t>(sizeof(T));
  const T* E = static_cast<const T*>(a.E);
  // This block's rows of E: row i at rowsE + (i - r0) n.
  const T* rowsE = kSharedE ? reinterpret_cast<const T*>(smem)
                            : E + static_cast<size_t>(r0) * n;
  if (kSharedE) {
    T* dst = reinterpret_cast<T*>(smem);
    const T* src = E + static_cast<size_t>(r0) * n;
    const size_t cnt = static_cast<size_t>(r1 - r0) * n;
    for (size_t k = tid; k < cnt; k += kThreads) dst[k] = __ldg(src + k);
  }
  if (a.runs != nullptr && me == 0 && tid == 0) atomicAdd(a.runs, 1ull);
  const T itk = ld<T>(a.itk, 0);
  const int L = a.offsets[a.nseg];
  for (int q = tid; q < N; q += kThreads) s.flag[q] = 0;
  for (int k = tid; k < N; k += kThreads) {
    s.e[k] = a.e_is_zero ? T(0) : ld<T>(a.e, k);
    s.p[k] = T(0);
  }
  __syncthreads();
  for (int seg = tid; seg < a.nseg; seg += kThreads) {
    const int lo = a.offsets[seg];
    if (lo < a.offsets[seg + 1]) s.flag[lo] = 1;
  }
  __syncthreads();

  auto xi = [&](int k) -> T { return a.nsp[k] ? T(1) : T(0); };
  auto label = [&](int k) -> long long {
    return __ldg(reinterpret_cast<const long long*>(a.labels) + k);
  };
  // Node k's component value v[lab] (0 for a label outside the sums).
  auto at_label = [&](const T* v, int k) -> T {
    const long long lab = label(k);
    return lab >= 0 && lab < a.nseg ? v[lab] : T(0);
  };
  // The projected coefficient c of node k (not deflated).
  auto coef = [&](int k) -> T {
    if (!a.nsp[k]) return T(0);
    const T x = ld<T>(a.xx, k);
    return at_label(s.tot, k) / (x > T(0) || x < T(0) ? x : T(1));
  };
  // The owner of row i and its slot in the owner's buffer.
  auto owner = [&](int i) { return i / R; };

  int ex = 0;  // exchanges so far: the buffers alternate
  if (!a.e_is_zero) {
    // u = E e1 over this block's rows, its share of w = E^T e2.
    T* rv = s.rowv + (ex & 1) * 2 * R;
    T* pt = s.part + (ex & 1) * n;
    for (int i = r0 + warp; i < r1; i += kWarps) {
      const T t = row_dot(rowsE + static_cast<size_t>(i - r0) * n, s.e, n,
                          lane);
      if (lane == 0) rv[i - r0] = t;
    }
    for (int j = tid; j < n; j += kThreads) {
      T acc = T(0);
      for (int i = r0; i < r1; ++i)
        acc += rowsE[static_cast<size_t>(i - r0) * n + j] * s.e[n + i];
      pt[j] = acc;
    }
    exchange<kGlobalState>();
    for (int j = tid; j < n; j += kThreads) {
      T acc = T(0);
      for (int b = 0; b < kBlocks; ++b)
        acc += peer_ld<T, kGlobalState>(pt, b, me, stride, j);
      s.p[j] = acc;
    }
    for (int i = tid; i < m; i += kThreads) {
      const int b = owner(i);
      s.p[n + i] = peer_ld<T, kGlobalState>(rv, b, me, stride, i - b * R);
    }
    ++ex;
    __syncthreads();
  }
  if (a.deflated) {
    // The near-singular count of every component, 1 where it is 0.
    segment_sums<T>(a, s, L, [&](int k) { return xi(k); });
    for (int seg = tid; seg < a.nseg; seg += kThreads)
      s.cnt[seg] = s.tot[seg] > T(0) ? s.tot[seg] : T(1);
    __syncthreads();
  }

  for (int sweep = 0; sweep < a.sweeps; ++sweep) {
    // The residual of every node (in d for now).
    for (int k = tid; k < N; k += kThreads)
      s.d[k] = (ld<T>(a.r, k) - ld<T>(a.g, k) * s.e[k]) + itk * s.p[k];
    __syncthreads();
    if (!a.deflated) {
      segment_sums<T>(a, s, L, [&](int k) { return s.d[k] * xi(k); });
      for (int k = tid; k < N; k += kThreads)
        s.d[k] = s.d[k] - ld<T>(a.Axi, k) * coef(k);
      __syncthreads();
    }
    // The half solved first: d1 (columns) or d2 (rows).
    {
      const int k0 = a.transpose ? n : 0, k1 = a.transpose ? N : n;
      for (int k = k0 + tid; k < k1; k += kThreads)
        s.d[k] = s.d[k] / ld<T>(a.g, k);
    }
    __syncthreads();
    T* rv = s.rowv + (ex & 1) * 2 * R;
    T* pt = s.part + (ex & 1) * n;
    if (!a.transpose) {
      // t = E d1 and d2 over this block's rows, then its share of E^T d2.
      for (int i = r0 + warp; i < r1; i += kWarps) {
        const T t = row_dot(rowsE + static_cast<size_t>(i - r0) * n, s.d,
                            n, lane);
        if (lane == 0) {
          rv[i - r0] = t;
          rv[R + i - r0] = (s.d[n + i] + itk * t) / ld<T>(a.g, n + i);
        }
      }
      __syncthreads();
      for (int j = tid; j < n; j += kThreads) {
        T acc = T(0);
        for (int i = r0; i < r1; ++i)
          acc += rowsE[static_cast<size_t>(i - r0) * n + j] * rv[R + i - r0];
        pt[j] = acc;
      }
      exchange<kGlobalState>();
      ++ex;
      for (int j = tid; j < n; j += kThreads) {
        T tw = T(0);
        for (int b = 0; b < kBlocks; ++b)
          tw += peer_ld<T, kGlobalState>(pt, b, me, stride, j);
        if (a.deflated) {
          s.e[j] = s.e[j] + s.d[j];
          s.p[j] = s.p[j] + tw;
        } else {
          const T c = coef(j);
          s.e[j] = (s.e[j] + xi(j) * c) + s.d[j];
          s.p[j] = (s.p[j] + c * ld<T>(a.Etxi2, j)) + tw;
        }
      }
      for (int i = tid; i < m; i += kThreads) {
        const int b = owner(i), k = n + i;
        const T t = peer_ld<T, kGlobalState>(rv, b, me, stride, i - b * R);
        const T d2 = peer_ld<T, kGlobalState>(rv, b, me, stride,
                                              R + i - b * R);
        if (a.deflated) {
          s.e[k] = s.e[k] + d2;
          s.p[k] = s.p[k] + t;
        } else {
          const T c = coef(k);
          s.e[k] = (s.e[k] + xi(k) * c) + d2;
          s.p[k] = (s.p[k] + c * ld<T>(a.Exi1, i)) + t;
        }
      }
    } else {
      // This block's share of tw = E^T d2 ...
      for (int j = tid; j < n; j += kThreads) {
        T acc = T(0);
        for (int i = r0; i < r1; ++i)
          acc += rowsE[static_cast<size_t>(i - r0) * n + j] * s.d[n + i];
        pt[j] = acc;
      }
      exchange<kGlobalState>();
      ++ex;
      // ... then d1 and the columns' update in every block ...
      for (int j = tid; j < n; j += kThreads) {
        T tw = T(0);
        for (int b = 0; b < kBlocks; ++b)
          tw += peer_ld<T, kGlobalState>(pt, b, me, stride, j);
        const T d1 = (s.d[j] + itk * tw) / ld<T>(a.g, j);
        s.d[j] = d1;
        if (a.deflated) {
          s.e[j] = s.e[j] + d1;
          s.p[j] = s.p[j] + tw;
        } else {
          const T c = coef(j);
          s.e[j] = (s.e[j] + xi(j) * c) + d1;
          s.p[j] = (s.p[j] + c * ld<T>(a.Etxi2, j)) + tw;
        }
      }
      __syncthreads();
      // ... t = E d1 over this block's rows ...
      T* rv2 = s.rowv + (ex & 1) * 2 * R;
      for (int i = r0 + warp; i < r1; i += kWarps) {
        const T t = row_dot(rowsE + static_cast<size_t>(i - r0) * n, s.d,
                            n, lane);
        if (lane == 0) rv2[i - r0] = t;
      }
      exchange<kGlobalState>();
      ++ex;
      // ... and the rows' update in every block.
      for (int i = tid; i < m; i += kThreads) {
        const int b = owner(i), k = n + i;
        const T t = peer_ld<T, kGlobalState>(rv2, b, me, stride, i - b * R);
        if (a.deflated) {
          s.e[k] = s.e[k] + s.d[k];
          s.p[k] = s.p[k] + t;
        } else {
          const T c = coef(k);
          s.e[k] = (s.e[k] + xi(k) * c) + s.d[k];
          s.p[k] = (s.p[k] + c * ld<T>(a.Exi1, i)) + t;
        }
      }
    }
    __syncthreads();
    if (a.deflated) {
      // Project each near-singular component's mean out.
      segment_sums<T>(a, s, L, [&](int k) { return s.e[k] * xi(k); });
      for (int k = tid; k < N; k += kThreads) {
        const long long lab = label(k);
        if (!a.nsp[k] || lab < 0 || lab >= a.nseg) continue;
        const T mk = s.tot[lab] / s.cnt[lab];
        s.e[k] = s.e[k] - mk;
        s.p[k] = s.p[k] - mk * (k < n ? ld<T>(a.Etxi2, k)
                                      : ld<T>(a.Exi1, k - n));
      }
      __syncthreads();
    }
  }
  // Every block holds the same e; each writes its share.
  T* out = static_cast<T*>(a.out);
  const int share = (N + kBlocks - 1) / kBlocks;
  const int k1 = min(N, (me + 1) * share);
  for (int k = me * share + tid; k < k1; k += kThreads) out[k] = s.e[k];
  // No block leaves while a peer may still read its buffers.
  cg::this_cluster().sync();
}

template <typename T, bool kSharedE, bool kGlobalState>
int launch_as(const Args& a, size_t smem, int dev, cudaStream_t st) {
  const auto fn = bip_smooth_kernel<T, kSharedE, kGlobalState>;
  // What was set or checked already, a device at a time (as in mis.cu).
  static bool wide[kMaxDevices] = {};
  static size_t allowed[kMaxDevices] = {};
  static bool fits_any[kMaxDevices] = {};
  static size_t fits[kMaxDevices] = {};
  cudaError_t err;
  if (!wide[dev]) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide[dev] = true;
  }
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fits_any[dev] || smem > fits[dev]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(fn), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kNoCluster;
    fits_any[dev] = true;
    if (smem > fits[dev]) fits[dev] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_layout(const Args& a, int layout, size_t smem, int dev,
                  cudaStream_t st) {
  switch (layout) {
    case 0:
      return launch_as<T, true, false>(a, smem, dev, st);
    case 1:
      return launch_as<T, false, false>(a, smem, dev, st);
    default:
      return launch_as<T, false, true>(a, smem, dev, st);
  }
}

}  // namespace

extern "C" int bip_smooth_launch(const int64_t* args) {
  Args a;
  a.E = reinterpret_cast<const void*>(args[0]);
  a.g = reinterpret_cast<const void*>(args[1]);
  a.r = reinterpret_cast<const void*>(args[2]);
  a.e = reinterpret_cast<const void*>(args[3]);
  a.itk = reinterpret_cast<const void*>(args[4]);
  a.labels = reinterpret_cast<const int64_t*>(args[5]);
  a.nsp = reinterpret_cast<const bool*>(args[6]);
  a.Axi = reinterpret_cast<const void*>(args[7]);
  a.xx = reinterpret_cast<const void*>(args[8]);
  a.Exi1 = reinterpret_cast<const void*>(args[9]);
  a.Etxi2 = reinterpret_cast<const void*>(args[10]);
  a.order = reinterpret_cast<const int32_t*>(args[11]);
  a.offsets = reinterpret_cast<const int32_t*>(args[12]);
  a.out = reinterpret_cast<void*>(args[13]);
  a.ws = reinterpret_cast<unsigned char*>(args[14]);
  a.m = static_cast<int>(args[15]);
  a.n = static_cast<int>(args[16]);
  a.nseg = static_cast<int>(args[17]);
  a.sweeps = static_cast<int>(args[18]);
  a.transpose = static_cast<int>(args[19]);
  a.deflated = static_cast<int>(args[20]);
  a.e_is_zero = static_cast<int>(args[21]);
  const int layout = static_cast<int>(args[22]);
  a.rows = static_cast<int>(args[23]);
  const size_t smem = static_cast<size_t>(args[24]);  // kernels.py
  a.state_bytes = args[25];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[26]);
  const int dev = static_cast<int>(args[27]);
  const int dtype = static_cast<int>(args[28]);  // f32, f64
  a.runs = reinterpret_cast<unsigned long long*>(args[29]);
  if (dtype != 0 && dtype != 1) return kBadDtype;
  const size_t item = dtype == 0 ? 4 : 8;
  // The shape arithmetic of kernels.py::bip_smooth_layout, checked.
  const int rows = (a.m + kBlocks - 1) / kBlocks;
  const size_t state = state_bytes(a.m, a.n, a.nseg, rows, item);
  const size_t panel = align16(static_cast<size_t>(rows) * a.n * item);
  const size_t want_smem =
      layout == 0 ? panel + state : (layout == 1 ? state : 0);
  const bool ok = a.m > 0 && a.n > 0 && a.nseg > 0 && a.sweeps >= 0 &&
                  a.rows == rows && layout >= 0 && layout <= 2 &&
                  static_cast<size_t>(a.state_bytes) == state &&
                  smem == want_smem && (layout < 2 || a.ws != nullptr) &&
                  (a.e_is_zero || a.e != nullptr) && dev >= 0 &&
                  dev < kMaxDevices;
  if (!ok) return kBadLayout;
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 0 ? launch_layout<float>(a, layout, smem, dev, st)
                    : launch_layout<double>(a, layout, smem, dev, st);
}

extern "C" const char* bip_smooth_error_string(int code) {
  switch (code) {
    case kBadLayout:
      return "the arguments disagree with kernels.py::bip_smooth_layout";
    case kNoCluster:
      return "no cluster of 16 blocks fits on the card "
             "(cudaOccupancyMaxActiveClusters gives 0)";
    case kBadDtype:
      return "the level is not float32 or float64";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
