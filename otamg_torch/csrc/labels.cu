// Label propagation on the bipartite edge mask of a Newton system for
// Hopper (sm_90a): the component labels in one launch with no host read.
//
// Replaces the lax.while_loop of otamg/amg/graph.py::
// connected_components_bipartite (no Pallas kernel: XLA runs the loop on
// the TPU), whose torch-op form read its change flag on the host once a
// block of rounds (otamg_torch/amg/kernels.py::label_rounds_plain reads it
// every round).  With the rounds on the card the whole front of a Newton
// solve (transform, components, AMG setup) can be one CUDA graph.
//
// Nodes: columns 0..n-1, rows n..n+m-1 (N = n + m), an edge between row
// n + i and column j where E[i, j] != 0.  From L = 0..N-1, each round
//   lr2 = min(lr, min{lc_j : E_ij != 0})        (the row hook)
//   lc2 = min(lc, min{lr2_i : E_ij != 0})       (the column hook)
//   L2 = [lc2, lr2];  L2 = L2[L2];  L2 = L2[L2]  (two jumps on a snapshot)
// and the rounds stop after the first one that changes nothing, or at
// max_rounds.  Every step is a minimum or a gather of integers, so the
// labels and the round count equal the plain loop's on every input, the
// inputs that stop at the cap included.
//
// Bound: E read once (m n itemsize bytes); the labels written once.  The
// rounds depend on each other: a round is two hooks, each ended by a
// barrier across the cluster, so rounds x 2 barriers is a latency floor
// whatever the bandwidth.
//
// Design:
// * One thread-block cluster of 16 blocks.  Block b owns a panel of rows
//   and a panel of columns (kernels.py::label_layout: `rows` and `cols`,
//   multiples of 32).
// * E is read once, in 32 x 32 tiles spread over the cluster's warps: lane
//   l loads column l of each of the tile's 32 rows (neighbouring lanes on
//   neighbouring addresses) and a ballot makes each row's word; 32 more
//   ballots transpose the tile into its columns' words.  The row words go
//   to the panel of the rows' owner, the column words to the columns'
//   owner: layout 0 in the owners' shared memory (distributed shared
//   memory), layout 1 in a global workspace.  No round reads E again.
// * Every block keeps the whole label vector, int32, in its shared
//   memory.  A warp hooks each of its rows with __ffs over the set bits of
//   the row's words and writes lr2 into every peer's copy; a cluster
//   barrier; the same for the columns (from lr2) with lc2; a barrier.
//   Every block then holds the same new vector, does both jumps and the
//   change test on its own, and reaches the same decision with no further
//   reduction.
// * The peers write each round's new vector into one of three buffers in
//   turn: a block that starts the next round's hook writes into none that
//   a slower block still reads (the current labels and the new ones) in
//   its jumps and test.
//
// C interface, loaded with ctypes: labels_launch takes its arguments
// packed in one int64 array, launches on the given stream and device, does
// not synchronise and returns cudaGetLastError() or one of the codes
// below.

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

// Ints of shared memory besides the panels: three label vectors the peers
// write in turn and the jumps' snapshot (kernels.py::label_layout).
__host__ __device__ constexpr size_t state_words(int N) {
  return 4 * static_cast<size_t>(N);
}

struct Args {
  const void* E;
  int64_t* labels;
  int32_t* rounds;
  uint32_t* ws;  // layout 1: the row words (m Wn), then the column words
  int m;
  int n;
  int max_rounds;
  int rows;  // a block's rows and columns, multiples of 32
  int cols;
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// E != 0 packed: row i's word w has bit b for column 32 w + b, column j's
// word w bit b for row 32 w + b.  Each warp of the cluster takes tiles in
// turn; every word of every panel is written by exactly one tile.
template <typename T, bool kGlobalBits>
__device__ void pack(const Args& a, uint32_t* rowbits, uint32_t* colbits) {
  cg::cluster_group cluster = cg::this_cluster();
  const T* E = static_cast<const T*>(a.E);
  const int m = a.m, n = a.n;
  const int Wn = (n + 31) >> 5, Wm = (m + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int tiles = Wm * Wn;
  for (int t = gw; t < tiles; t += kBlocks * kWarps) {
    const int ti = t / Wn, tj = t % Wn;
    const int row0 = 32 * ti, col = 32 * tj + lane;
    bool v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int row = row0 + r;
      v[r] = row < m && col < n &&
             E[static_cast<size_t>(row) * n + col] != static_cast<T>(0);
    }
    uint32_t rw = 0u, cw = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t w = __ballot_sync(kFull, v[r]);
      if (lane == r) rw = w;  // row row0 + lane, word tj
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const uint32_t w = __ballot_sync(kFull, (rw >> c) & 1u);
      if (lane == c) cw = w;  // column 32 tj + lane, word ti
    }
    const int i = row0 + lane;
    if (i < m) {
      if (kGlobalBits) {
        rowbits[static_cast<size_t>(i) * Wn + tj] = rw;
      } else {
        const int owner = i / a.rows;
        cluster.map_shared_rank(rowbits, owner)[
            static_cast<size_t>(i - owner * a.rows) * Wn + tj] = rw;
      }
    }
    if (col < n) {
      if (kGlobalBits) {
        colbits[static_cast<size_t>(col) * Wm + ti] = cw;
      } else {
        const int owner = col / a.cols;
        cluster.map_shared_rank(colbits, owner)[
            static_cast<size_t>(col - owner * a.cols) * Wm + ti] = cw;
      }
    }
  }
}

template <typename T, bool kGlobalBits>
__global__ void __launch_bounds__(kThreads) labels_kernel(const Args a) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int m = a.m, n = a.n, N = n + m;
  const int Wn = (n + 31) >> 5, Wm = (m + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int me = blockIdx.x, nb = gridDim.x;  // the grid is one cluster
  // The three label vectors the peers write in turn: smem + k N.
  int* U = smem + 3 * N;
  const int r0 = min(m, me * a.rows), r1 = min(m, r0 + a.rows);
  const int c0 = min(n, me * a.cols), c1 = min(n, c0 + a.cols);
  uint32_t* rowbits;
  uint32_t* colbits;
  if (kGlobalBits) {
    rowbits = a.ws;
    colbits = a.ws + static_cast<size_t>(m) * Wn;
  } else {
    rowbits = reinterpret_cast<uint32_t*>(smem + state_words(N));
    colbits = rowbits + static_cast<size_t>(a.rows) * Wn;
  }
  // This block's panels: row i at (i - r0) Wn, column j at (j - c0) Wm.
  const uint32_t* myrows =
      kGlobalBits ? rowbits + static_cast<size_t>(r0) * Wn : rowbits;
  const uint32_t* mycols =
      kGlobalBits ? colbits + static_cast<size_t>(c0) * Wm : colbits;

  int cur = 2;  // the labels are at smem + cur N
  for (int i = threadIdx.x; i < N; i += kThreads) smem[cur * N + i] = i;
  int rounds = 0;
  if (a.max_rounds > 0) {
    cluster.sync();  // peers are set up
    pack<T, kGlobalBits>(a, rowbits, colbits);
    if (kGlobalBits) __threadfence();
    cluster.sync();
  }
  bool changed = true;
  while (changed && rounds < a.max_rounds) {
    const int* L = smem + cur * N;
    const int nxt = cur == 2 ? 0 : cur + 1;
    int* T2 = smem + nxt * N;
    // Row hook: lr2 into every peer's T2[n + i].
    for (int i = r0 + warp; i < r1; i += kWarps) {
      const uint32_t* row = myrows + static_cast<size_t>(i - r0) * Wn;
      int best = L[n + i];
      for (int w = lane; w < Wn; w += 32) {
        uint32_t x = row[w];
        while (x) {
          best = min(best, L[32 * w + __ffs(x) - 1]);
          x &= x - 1;
        }
      }
      best = warp_min(best);
      if (lane < nb) cluster.map_shared_rank(T2, lane)[n + i] = best;
    }
    cluster.sync();
    // Column hook from lr2: lc2 into every peer's T2[j].
    for (int j = c0 + warp; j < c1; j += kWarps) {
      const uint32_t* col = mycols + static_cast<size_t>(j - c0) * Wm;
      int best = L[j];
      for (int w = lane; w < Wm; w += 32) {
        uint32_t x = col[w];
        while (x) {
          best = min(best, T2[n + 32 * w + __ffs(x) - 1]);
          x &= x - 1;
        }
      }
      best = warp_min(best);
      if (lane < nb) cluster.map_shared_rank(T2, lane)[j] = best;
    }
    cluster.sync();
    // Two jumps over the full snapshot, then the change test.
    for (int i = threadIdx.x; i < N; i += kThreads) U[i] = T2[T2[i]];
    __syncthreads();
    int ch = 0;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const int v = U[U[i]];
      ch |= v != L[i];
      T2[i] = v;
    }
    changed = __syncthreads_or(ch) != 0;
    cur = nxt;
    ++rounds;
  }
  // Every block holds the same labels; each writes its share.
  const int share = (N + nb - 1) / nb;
  const int i1 = min(N, (me + 1) * share);
  for (int i = me * share + threadIdx.x; i < i1; i += kThreads)
    a.labels[i] = smem[cur * N + i];
  if (me == 0 && threadIdx.x == 0) *a.rounds = rounds;
}

template <typename T, bool kGlobalBits>
int launch_as(const Args& a, size_t smem, int dev, cudaStream_t st) {
  const auto fn = labels_kernel<T, kGlobalBits>;
  // What was set or checked already, a device at a time (as in mis.cu).
  static bool wide[kMaxDevices] = {};
  static size_t allowed[kMaxDevices] = {};
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
  if (smem > fits[dev]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(fn), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kNoCluster;
    fits[dev] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_layout(const Args& a, int layout, size_t smem, int dev,
                  cudaStream_t st) {
  return layout == 0 ? launch_as<T, false>(a, smem, dev, st)
                     : launch_as<T, true>(a, smem, dev, st);
}

}  // namespace

extern "C" int labels_launch(const int64_t* args) {
  Args a;
  a.E = reinterpret_cast<const void*>(args[0]);
  a.labels = reinterpret_cast<int64_t*>(args[1]);
  a.rounds = reinterpret_cast<int32_t*>(args[2]);
  a.m = static_cast<int>(args[3]);
  a.n = static_cast<int>(args[4]);
  a.max_rounds = static_cast<int>(args[5]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[6]);
  const int dev = static_cast<int>(args[7]);
  a.ws = reinterpret_cast<uint32_t*>(args[8]);
  const int layout = static_cast<int>(args[9]);
  const int blocks = static_cast<int>(args[10]);
  a.rows = static_cast<int>(args[11]);
  a.cols = static_cast<int>(args[12]);
  const size_t smem = static_cast<size_t>(args[13]);  // kernels.py
  const int dtype = static_cast<int>(args[14]);       // f32, f64
  // The shape arithmetic of kernels.py::label_layout, checked.
  const int Wn = (a.n + 31) >> 5, Wm = (a.m + 31) >> 5;
  const int rows = 32 * ((a.m + 32 * kBlocks - 1) / (32 * kBlocks));
  const int cols = 32 * ((a.n + 32 * kBlocks - 1) / (32 * kBlocks));
  const size_t panels = static_cast<size_t>(rows) * Wn +
                        static_cast<size_t>(cols) * Wm;
  const size_t words = state_words(a.n + a.m) + (layout == 0 ? panels : 0);
  const bool ok = a.m > 0 && a.n > 0 && a.max_rounds >= 0 &&
                  (layout == 0 || (layout == 1 && a.ws != nullptr)) &&
                  blocks == kBlocks && a.rows == rows && a.cols == cols &&
                  smem == 4 * words && dev >= 0 && dev < kMaxDevices;
  if (!ok) return kBadLayout;
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0:
      return launch_layout<float>(a, layout, smem, dev, st);
    case 1:
      return launch_layout<double>(a, layout, smem, dev, st);
    default:
      return kBadDtype;
  }
}

extern "C" const char* labels_error_string(int code) {
  switch (code) {
    case kBadLayout:
      return "the arguments disagree with kernels.py::label_layout";
    case kNoCluster:
      return "no cluster of 16 blocks fits on the card "
             "(cudaOccupancyMaxActiveClusters gives 0)";
    case kBadDtype:
      return "E is not float32 or float64";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
