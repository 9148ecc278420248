// The greedy rounds of the approximate-MIS C/F splitting for Hopper
// (sm_90a), in one launch with no host read.
//
// Replaces the lax.while_loop of otamg/amg/graph.py::mis_dense (no Pallas
// kernel: XLA runs the loop on the TPU), whose torch-op form read its
// go-flag on the host once a round (otamg_torch/amg/kernels.py::
// mis_rounds_plain).  With the rounds on the card the whole AMG setup of
// a Newton solve can be captured in one CUDA graph.
//
// State, with deg the f32 degree plus its random tie-break (0 on nodes
// with no strong connection, which start as F):
//   isF = active & deg == 0, isC = 0, isU = active & !isF
// and while |C| < Ncnt/2 and |U| > N0 (at most max_rounds times):
//   sel  = deg > 0 & deg > max{deg_j : As_ij & deg_j > 0}
//   isC |= sel;  nbrC = any_j As_ij & isC_j
//   isF |= nbrC & active & !isC;  isU = active & !(isF | isC)
//   deg  = isU ? deg : 0
//   absorb = |U| <= N0:  isC |= absorb & isU;  isU &= !absorb
// Every step is a comparison, a max or an integer count compared with
// the same f32 thresholds as the torch ops, so the split equals the
// plain loop's bit for bit.
//
// Bound: As read once (c^2 bytes).  The method's operations, one AND of
// a row's word with a mask word in each pass, 2 c ceil(c/32) a round at
// the card's 32-bit logic rate, take less time than those bytes at every
// size the kernel takes (chip_smoke.py::mis_bound).  Apart from that,
// the rounds depend on each other: a round is two passes, each ended by
// a barrier across the blocks, so rounds x 2 barriers is a latency floor
// whatever the bandwidth.
//
// Design (tests/mis_steps.py is the same method in torch ops):
// * The go-test comes first, from the degrees and flags alone: a call
//   that runs no round reads no As.
// * As is read once, 16 bytes a lane with neighbouring lanes on
//   neighbouring addresses, and packed into 32-bit words, ceil(c/32) a
//   row; no round reads As again.  The rows are cut into panels of
//   `rows` (a multiple of 32), one a block.
// * The state is bits too: the masks C, S (selectable: deg > 0 at the
//   start and still undecided), U, F and A (active), a word per 32
//   nodes, beside the read-only degrees.  S stands for the loop's
//   deg > 0: after a round deg_j > 0 exactly where j is U with a
//   positive degree, and an absorb ends the rounds.
// * A round visits only its rows: pass 1 the S rows (the max of deg over
//   the set bits of row & S), pass 2 the rows still U but not C (any bit
//   of row & C).  A warp takes the rows of one bit position, so a block
//   finds its next rows with one ballot over 32 words.
// * One thread-block cluster of 16 blocks at every c (past the portable
//   8, so the launch allows a non-portable size).  Layouts
//   (kernels.py::mis_layout): 0, each block's panel in its shared memory
//   (c <= 5,120); 1, the panels in a global workspace, which L2 holds
//   (8 MB at c = 8,192), read by the block that packed them.  Only the
//   rows that are U or S at the start are packed (on the path at most
//   the active ones: 13-17 of 157-640 rows at the deeper levels).  Every
//   block of the cluster keeps the whole C and S: after pass 1 a block
//   writes the words of its rows of C into every peer's shared memory,
//   after pass 2 its words of S and its C and U counts, and the cluster
//   meets at a barrier; every block then runs the same go-test and
//   absorb on the same integers.  Where fewer panels cover c (c = 100:
//   4 panels of 32 rows), the other blocks own no row and only keep
//   their copy of the state.
//
// C interface, loaded with ctypes: mis_launch takes its arguments packed
// in one int64 array, launches on the given stream and device, does not
// synchronise and returns cudaGetLastError() or one of the codes below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 16;  // the cluster
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 4;  // pieces of rows a warp packs at once
constexpr int kBadLayout = -1;
constexpr int kNoCluster = -2;

// Words of shared memory besides the panel: the degrees (32 a word of
// nodes), C, S, U, F and A, the blocks' counts and the reduction's
// scratch (kernels.py::mis_layout).
__host__ __device__ constexpr int state_words(int W) {
  return 37 * W + 2 * kBlocks + kWarps + 2;
}

struct Args {
  const uint8_t* As;
  const uint8_t* active;
  const float* deg;
  const float* ncnt;
  const float* n0;
  uint8_t* isC;
  uint8_t* isF;
  uint8_t* isU;
  int32_t* rounds;
  uint32_t* ws;  // layout 1: the panels, row i at ws[i W]
  int c;
  int max_rounds;
  int rows;  // a block's rows, a multiple of 32
};

// Bit b of the result: byte b of x is not 0.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t nonzero16(uint4 q) {
  return nonzero4(q.x) | nonzero4(q.y) << 4 | nonzero4(q.z) << 8 |
         nonzero4(q.w) << 12;
}

// The rows of this block that a round can visit (U or S at the start)
// packed into bits (row i at bits[(i - r0) W]): bit j % 32 of word j / 32
// is As[i, j] != 0.  Warp q takes the rows with bit q of the block's words
// set, in pieces of 30 chunks of 16 bytes, kUnroll in flight: lane l
// loads the aligned chunk l of its piece (32 of them) and makes it 16
// bits; each even lane below 30 then joins its chunk and the next two
// into the word that starts s bits in, s being the row's offset from
// 16-byte alignment: 15 words a piece.
__device__ void pack(const uint8_t* As, int c, int W, int r0, int w0, int nw,
                     const uint32_t* U, const uint32_t* S, uint32_t* bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pieces = (W + 14) / 15;
  int k0 = -32;
  uint32_t todo = 0u;
  auto next_row = [&]() {  // the warp's next row, or -1
    while (!todo) {
      k0 += 32;
      if (k0 >= nw) return -1;
      const int k = k0 + lane;
      todo = __ballot_sync(
          kFull, k < nw && (((U[w0 + k] | S[w0 + k]) >> warp) & 1u));
    }
    const int i = 32 * (w0 + k0 + __ffs(todo) - 1) + warp;
    todo &= todo - 1;
    return i;
  };
  int i = next_row(), p = 0;
  while (i >= 0) {
    int ti[kUnroll], tp[kUnroll];
    uint4 v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      ti[q] = i;
      tp[q] = p;
      v[q] = make_uint4(0u, 0u, 0u, 0u);
      if (i >= 0) {
        const uintptr_t at =
            reinterpret_cast<uintptr_t>(As) + static_cast<size_t>(i) * c;
        const int s = static_cast<int>(at & 15);
        const int ch = 30 * p + lane;
        if (ch < (s + c + 15) >> 4)
          v[q] = __ldg(reinterpret_cast<const uint4*>(at - s) + ch);
        if (++p == pieces) {
          p = 0;
          i = next_row();
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (ti[q] < 0) break;  // the same for the whole warp
      const int s = static_cast<int>(
          (reinterpret_cast<uintptr_t>(As) + static_cast<size_t>(ti[q]) * c) &
          15);
      const uint32_t m = nonzero16(v[q]);
      const uint32_t lo = m | __shfl_down_sync(kFull, m, 1) << 16;
      const uint32_t hi = __shfl_down_sync(kFull, m, 2);  // s < 16 bits used
      const int w = 15 * tp[q] + (lane >> 1);
      if (!(lane & 1) && lane < 30 && w < W) {
        uint32_t word = __funnelshift_r(lo, hi, s);
        if (w == W - 1 && (c & 31)) word &= (1u << (c & 31)) - 1u;
        bits[static_cast<size_t>(ti[q] - r0) * W + w] = word;
      }
    }
  }
}

__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = red[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (threadIdx.x == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

// Words [w0, w0 + nw) of mask, this block's, into every peer's copy.
__device__ void share(uint32_t* mask, int w0, int nw, int me, int nb,
                      int from, int stride) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int t = from; t < nb * nw; t += stride) {
    const int p = t / nw, w = w0 + t % nw;
    if (p != me) cluster.map_shared_rank(mask, p)[w] = mask[w];
  }
}

template <bool kGlobalBits>
__global__ void __launch_bounds__(kThreads) mis_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int c = a.c, W = (c + 31) >> 5;
  float* deg = reinterpret_cast<float*>(smem);
  uint32_t* C = smem + 32 * W;
  uint32_t* S = C + W;
  uint32_t* U = S + W;
  uint32_t* F = U + W;
  uint32_t* A = F + W;
  int* cnt = reinterpret_cast<int*>(A + W);  // C and U counts a block
  int* red = cnt + 2 * kBlocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x, me = blockIdx.x;  // the grid is one cluster
  const int r0 = min(c, me * a.rows), r1 = min(c, r0 + a.rows);
  const int w0 = r0 >> 5, nw = (r1 - r0 + 31) >> 5;
  uint32_t* bits = kGlobalBits ? a.ws + static_cast<size_t>(r0) * W
                               : smem + state_words(W);
  const float half = *a.ncnt / 2.0f, n0 = *a.n0;

  // Every block builds the whole state from deg and active; no As yet.
  int cu = 0;
  for (int w = warp; w < W; w += kWarps) {
    const int i = 32 * w + lane;
    const float d = i < c ? a.deg[i] : 0.0f;
    const bool act = i < c && a.active[i] != 0;
    deg[i] = d;
    const uint32_t am = __ballot_sync(kFull, act);
    const uint32_t fm = __ballot_sync(kFull, act && d == 0.0f);
    const uint32_t sm = __ballot_sync(kFull, d > 0.0f);
    if (lane == 0) {
      A[w] = am;
      F[w] = fm;
      U[w] = am & ~fm;
      S[w] = sm;
      C[w] = 0u;
      cu += __popc(am & ~fm);
    }
  }
  int ctot = 0, utot = block_sum(cu, red);
  bool go = static_cast<float>(ctot) < half && static_cast<float>(utot) > n0;
  bool absorbed = false;
  int rounds = 0;
  if (go && a.max_rounds > 0) {
    cg::this_cluster().sync();  // peers are set up
    pack(a.As, c, W, r0, w0, nw, U, S, bits);
    __syncthreads();
  }
  // Pass 1 splits a word over `split` lanes where a row has fewer than 32.
  const int split = W > 16 ? 1 : W > 8 ? 2 : W > 4 ? 4 : W > 2 ? 8 : 16;
  const int bits_a_lane = 32 / split;
  const uint32_t part =
      split == 1 ? kFull
                 : ((1u << bits_a_lane) - 1u) << bits_a_lane * (lane % split);
  while (go && rounds < a.max_rounds) {
    // Pass 1: an S row is selected where its degree beats every S
    // neighbour's.  Warp q takes the rows with bit q of this block's
    // words set.
    for (int k0 = 0; k0 < nw; k0 += 32) {
      const int k = k0 + lane;
      uint32_t todo =
          __ballot_sync(kFull, k < nw && ((S[w0 + k] >> warp) & 1u));
      while (todo) {
        const int kk = k0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int i = 32 * (w0 + kk) + warp;
        const uint32_t* row = bits + static_cast<size_t>(i - r0) * W;
        float m = -INFINITY;
        for (int w = lane / split; w < W; w += 32 / split) {
          uint32_t x = row[w] & S[w] & part;
          while (x) {  // four loads in flight
            float d[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int b = __ffs(x) - 1;
              d[u] = b >= 0 ? deg[32 * w + b] : -INFINITY;
              x &= x - 1;
            }
            m = fmaxf(m, fmaxf(fmaxf(d[0], d[1]), fmaxf(d[2], d[3])));
          }
        }
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        if (lane == 0 && deg[i] > m) atomicOr(&C[w0 + kk], 1u << warp);
      }
    }
    __syncthreads();
    share(C, w0, nw, me, nb, threadIdx.x, kThreads);
    cg::this_cluster().sync();
    // Pass 2: the rows still U but not C that have a C neighbour are F.
    for (int k0 = 0; k0 < nw; k0 += 32) {
      const int k = k0 + lane;
      uint32_t todo = __ballot_sync(
          kFull, k < nw && (((U[w0 + k] & ~C[w0 + k]) >> warp) & 1u));
      while (todo) {
        const int kk = k0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const uint32_t* row =
            bits + static_cast<size_t>(32 * (w0 + kk) + warp - r0) * W;
        bool hit = false;
        for (int v = 0; v < W && !hit; v += 32) {
          const int w = v + lane;
          hit = __any_sync(kFull, w < W && (row[w] & C[w]) != 0u);
        }
        if (lane == 0 && hit) atomicOr(&F[w0 + kk], 1u << warp);
      }
    }
    __syncthreads();
    // This block's words: the new U and S, and the counts.
    if (warp == 0) {
      int cc = 0;
      cu = 0;
      for (int k = lane; k < nw; k += 32) {
        const int w = w0 + k;
        const uint32_t u = A[w] & ~(F[w] | C[w]);
        U[w] = u;
        S[w] &= u;
        cc += __popc(C[w]);
        cu += __popc(u);
      }
      for (int o = 16; o > 0; o >>= 1) {
        cc += __shfl_xor_sync(kFull, cc, o);
        cu += __shfl_xor_sync(kFull, cu, o);
      }
      __syncwarp();
      share(S, w0, nw, me, nb, lane, 32);
      if (lane < nb) {
        int* to = cg::this_cluster().map_shared_rank(cnt, lane);
        to[2 * me] = cc;
        to[2 * me + 1] = cu;
      }
    }
    cg::this_cluster().sync();
    ctot = utot = 0;
    for (int p = 0; p < nb; ++p) {
      ctot += cnt[2 * p];
      utot += cnt[2 * p + 1];
    }
    // At most N0 undecided left: they join C (mis_set.m:60-63).  U is
    // then empty, so the go-test fails and no pass reads C again.
    absorbed = static_cast<float>(utot) <= n0;
    if (absorbed) {
      ctot += utot;
      utot = 0;
    }
    go = static_cast<float>(ctot) < half && static_cast<float>(utot) > n0;
    ++rounds;
  }
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const int w = i >> 5;
    const uint32_t bit = 1u << (i & 31);
    const bool u = (U[w] & bit) != 0u;
    a.isC[i] = (C[w] & bit) != 0u || (absorbed && u);
    a.isF[i] = (F[w] & bit) != 0u;
    a.isU[i] = u && !absorbed;
  }
  if (me == 0 && threadIdx.x == 0) *a.rounds = rounds;
}

template <bool kGlobalBits>
int launch_as(const Args& a, size_t smem, int dev, cudaStream_t st) {
  const auto fn = mis_kernel<kGlobalBits>;
  // What was set or checked already, a device at a time: the
  // non-portable cluster size, the largest shared-memory opt-in and the
  // largest shared memory with which the cluster was found to fit.
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

}  // namespace

extern "C" int mis_launch(const int64_t* args) {
  Args a;
  a.As = reinterpret_cast<const uint8_t*>(args[0]);
  a.active = reinterpret_cast<const uint8_t*>(args[1]);
  a.deg = reinterpret_cast<const float*>(args[2]);
  a.ncnt = reinterpret_cast<const float*>(args[3]);
  a.n0 = reinterpret_cast<const float*>(args[4]);
  a.isC = reinterpret_cast<uint8_t*>(args[5]);
  a.isF = reinterpret_cast<uint8_t*>(args[6]);
  a.isU = reinterpret_cast<uint8_t*>(args[7]);
  a.rounds = reinterpret_cast<int32_t*>(args[8]);
  a.c = static_cast<int>(args[9]);
  a.max_rounds = static_cast<int>(args[10]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[11]);
  const int dev = static_cast<int>(args[12]);
  a.ws = reinterpret_cast<uint32_t*>(args[13]);
  const int layout = static_cast<int>(args[14]);
  const int blocks = static_cast<int>(args[15]);
  a.rows = static_cast<int>(args[16]);
  const size_t smem = static_cast<size_t>(args[17]);  // kernels.py
  if (a.c <= 0) return 0;
  // The shape arithmetic of kernels.py::mis_layout, checked.
  const int W = (a.c + 31) >> 5;
  const int rows = 32 * ((a.c + 32 * kBlocks - 1) / (32 * kBlocks));
  const size_t words =
      state_words(W) + (layout == 0 ? static_cast<size_t>(rows) * W : 0);
  const bool ok = (layout == 0 || (layout == 1 && a.ws != nullptr)) &&
                  blocks == kBlocks && a.rows == rows && smem == 4 * words &&
                  dev >= 0 && dev < kMaxDevices;
  if (!ok) return kBadLayout;
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return layout == 0 ? launch_as<false>(a, smem, dev, st)
                     : launch_as<true>(a, smem, dev, st);
}

extern "C" const char* mis_error_string(int code) {
  switch (code) {
    case kBadLayout:
      return "the arguments disagree with kernels.py::mis_layout";
    case kNoCluster:
      return "no cluster of 16 blocks fits on the card "
             "(cudaOccupancyMaxActiveClusters gives 0)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
