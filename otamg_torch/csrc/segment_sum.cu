// Deterministic segment sum for Hopper (sm_90a):
//   out[s] = sum of data[j] over the j with labels[j] == s,  0 <= s < nseg.
//
// Replaces jax.ops.segment_sum as the JAX package uses it in
// otamg/amg/graph.py and otamg/amg/hierarchy.py (component sizes, the
// per-component kernel projections of the smoother, the deflated
// means).  XLA lowers it to a scatter-add; the JAX package has no Pallas
// kernel for it.  PyTorch's index_add_ on the card adds with atomics in
// no fixed order, so two runs of one solve on the card would take
// different paths; every sum here comes in a fixed order, and no launch
// synchronises with the host or allocates, so the AMG cycle that calls
// them can be captured in a CUDA graph.
//
// Bound: each input is read once and out written once (L*(s + 4) +
// nseg*(s + 4) bytes for L elements of s bytes through a plan), one add
// per element, so the function is bound by memory traffic.  At the main
// path's sizes (L, nseg of a few thousand) a call is a few microseconds
// of latency, and the floor is the chain of dependent adds of the
// largest segment, which the CPU's order forces: one f64 add's latency
// (about 4.1 ns on the H100) an element.
//
// * plan (segment_sum_plan): the labels were sorted once per labels
//   tensor (sparse/segment.py::segment_plan): `order` lists the
//   positions segment by segment, each run in index order, `offsets`
//   holds the run bounds, and a pair plan also `mid`, where each run
//   passes from the first vector to the second.  The labels are not read.
//   Segment blocks give each thread one segment whose runs hold at most
//   kLaneMax elements, summed from 0 in index order.  A segment with a
//   longer run goes to work blocks, which come first in the grid so that
//   the longest work starts first.  In an exact plan (nseg * L <=
//   SCAN_LIMIT for each half, the Class-1/2 hierarchies) the work blocks
//   find such runs themselves (no list to build) and add each run's
//   elements from 0 one after another in index order, so every sum
//   equals the CPU's index_add_ bit for bit.  That chain bounds an exact
//   call, and the design keeps everything else off it: seven warps of the
//   block stage the run in shared memory, kSeq values a round, while one
//   thread adds the round before, reading kLook values ahead of its adds.
//   Otherwise (a tiled plan) the long runs are in the plan's tile list: a
//   long run (the sparse levels, a million nodes in one segment) is cut
//   into tiles of kTile elements, each summed by a fixed tree with every
//   load issued before the adds (the run of an exact half is one tile,
//   summed in order); the last tile block of the segment to finish adds
//   the partials in tile order, and the bytes moved bound it.  A pair call (the bipartite smoother) sums each half
//   in its own order and adds the two once: segment_sum(a) +
//   segment_sum(b) in one launch.
// * scan (segment_sum_scan; a call without a plan, nseg * L small): thread
//   s walks all L elements in index order, staged tile by tile in shared
//   memory, where every thread reads the same element at once (a
//   broadcast), adding those of its segment.  O(nseg * L) work, no sort,
//   one launch: the one-off sums on labels made just before.
//
// C interface, loaded with ctypes: each function takes its arguments
// packed in one int64 array, launches on the given stream and device,
// does not synchronise and returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad dtype code).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;     // scan blocks
constexpr int kStage = 2048;      // scan: elements staged in shared memory
constexpr int kLaneMax = 32;      // plan: longest run a thread sums alone;
                                  // sparse/segment.py::LANE_MAX
constexpr int kChunk = 8;         // plan: values a thread loads at a time
constexpr int kTile = 4096;       // plan: elements of a tree tile;
                                  // sparse/segment.py::TILE
constexpr int kTileFields = 7;    // sparse/segment.py::TILE_FIELDS
constexpr int kWorkBlocks = 264;  // plan: work blocks at most, 2 an SM
constexpr int kPlanThreads = 256; // plan: a thread a segment, or a tile
constexpr int kStagers = kPlanThreads - 32;  // warps 1-7 stage a chain
constexpr int kSeq = 2048;        // chain: values staged a round
constexpr int kSeqEach = (kSeq + kStagers - 1) / kStagers;
constexpr int kLook = 8;          // chain: shared values read ahead

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ data, const int64_t* __restrict__ labels,
                T* __restrict__ out, int64_t L, int64_t nseg) {
  __shared__ int32_t lab_s[kStage];
  __shared__ T val_s[kStage];
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  for (int64_t base = 0; base < L; base += kStage) {
    const int n = static_cast<int>(L - base < kStage ? L - base : kStage);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t lab = labels[base + j];
      lab_s[j] = (lab >= 0 && lab < nseg) ? static_cast<int32_t>(lab) : -1;
      val_s[j] = data[base + j];
    }
    __syncthreads();
    const int32_t me = static_cast<int32_t>(s);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      if (lab_s[j] == me) acc += val_s[j];
    }
  }
  if (s < nseg) out[s] = acc;
}

// The summed values: position i < split reads a[i], the others
// b[i - split] (a single call passes split = L).
template <typename T>
struct Src {
  const T* __restrict__ a;
  const T* __restrict__ b;
  int split;
  __device__ __forceinline__ T operator()(int i) const {
    return i < split ? a[i] : b[i - split];
  }
};

struct Plan {
  const int32_t* __restrict__ order;
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ mid;    // null: one run a segment
  const int32_t* __restrict__ tiles;  // (ntiles, kTileFields)
  void* partials;                     // (ntiles,) 8-byte slots
  int32_t* counts;                    // (ntiles,), 0 between calls
};

// order[lo..hi), hi - lo <= kLaneMax, summed from 0 in order by one
// thread (the CPU's order), kChunk at a time, the next chunk's values
// and the positions of the one after loading while a chunk is added.
template <typename T>
__device__ T lane_seq(const Src<T>& src, const int32_t* __restrict__ order,
                      int lo, int hi) {
  int idx[kChunk];
  T v[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    idx[k] = lo + k < hi ? order[lo + k] : 0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) v[k] = lo + k < hi ? src(idx[k]) : T(0);
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    idx[k] = lo + kChunk + k < hi ? order[lo + kChunk + k] : 0;
  T acc = T(0);
  for (int base = lo; base < hi; base += kChunk) {
    T cur[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cur[k] = v[k];
    const int next = base + kChunk;
    if (next < hi) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        v[k] = next + k < hi ? src(idx[k]) : T(0);
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        idx[k] = next + kChunk + k < hi ? order[next + kChunk + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (base + k < hi) acc += cur[k];
  }
  return acc;
}

// Stager t (of kStagers) writes its slots j = t, t + kStagers, ... of one
// round: dst[j] = the value at order[base + j], or +0 past hi.  All its
// loads are issued before the first store.
template <typename T>
__device__ __forceinline__ void stage(const Src<T>& src,
                                      const int32_t* __restrict__ order,
                                      int base, int hi, T* dst, int t) {
  int idx[kSeqEach];
  T v[kSeqEach];
#pragma unroll
  for (int k = 0; k < kSeqEach; ++k) {
    const int j = t + k * kStagers;
    idx[k] = (j < kSeq && base + j < hi) ? order[base + j] : 0;
  }
#pragma unroll
  for (int k = 0; k < kSeqEach; ++k) {
    const int j = t + k * kStagers;
    v[k] = (j < kSeq && base + j < hi) ? src(idx[k]) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kSeqEach; ++k) {
    const int j = t + k * kStagers;
    if (j < kSeq) dst[j] = v[k];
  }
}

// acc + buf[0] + buf[1] + ... + buf[n - 1], one add after another, n a
// multiple of 2 kLook: the reads of the next kLook values are issued
// before the adds of the current ones, so no add waits on shared memory
// (buf holds kLook slots past n).  The +0 that pads a round leaves a sum
// that started at +0 as it is (such a sum is never -0).
template <typename T>
__device__ __forceinline__ T chain(const T* buf, int n, T acc) {
  T v0[kLook], v1[kLook];
#pragma unroll
  for (int k = 0; k < kLook; ++k) v0[k] = buf[k];
  for (int j0 = 0; j0 < n; j0 += 2 * kLook) {
#pragma unroll
    for (int k = 0; k < kLook; ++k) v1[k] = buf[j0 + kLook + k];
#pragma unroll
    for (int k = 0; k < kLook; ++k) acc += v0[k];
#pragma unroll
    for (int k = 0; k < kLook; ++k) v0[k] = buf[j0 + 2 * kLook + k];
#pragma unroll
    for (int k = 0; k < kLook; ++k) acc += v1[k];
  }
  return acc;
}

// order[lo..hi) summed from 0 in index order (the CPU's order) by thread
// 0 of the block, the result in thread 0.  Warps 1-7 stage round r + 1
// in one buffer while thread 0 adds round r from the other.  All threads
// call it.
template <typename T>
__device__ T seq_sum(const Src<T>& src, const int32_t* __restrict__ order,
                     int lo, int hi, T (*buf)[kSeq + kLook]) {
  const int t = static_cast<int>(threadIdx.x) - 32;
  if (t >= 0) stage(src, order, lo, hi, buf[0], t);
  __syncthreads();
  T acc = T(0);
  int r = 0;
  for (int base = lo; base < hi; base += kSeq) {
    if (threadIdx.x == 0) {
      const int n = hi - base < kSeq ? hi - base : kSeq;
      acc = chain(buf[r], (n + 2 * kLook - 1) & ~(2 * kLook - 1), acc);
    } else if (t >= 0 && base + kSeq < hi) {
      stage(src, order, base + kSeq, hi, buf[r ^ 1], t);
    }
    __syncthreads();
    r ^= 1;
  }
  return acc;
}

// Tile t of a long segment.  A tile that is the segment's only one writes
// out[seg]; otherwise its partial goes to plan scratch and the last tile
// of the segment to finish adds the partials in tile order (the first
// run's, then the second's) and writes out[seg].  All threads call it.
template <typename T>
__device__ void tile_sum(const Src<T>& src, const Plan& p, T* out, bool pair,
                         int t, T (*buf)[kSeq + kLook]) {
  __shared__ T red[kPlanThreads / 32];
  __shared__ bool last;
  const int32_t* d = p.tiles + static_cast<int64_t>(t) * kTileFields;
  const int seg = d[0], lo = d[1], hi = d[2], first = d[3], na = d[4],
            n = d[5];
  const bool seq = d[6] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T r = T(0);
  if (seq) {
    r = seq_sum(src, p.order, lo, hi, buf);
  } else {
    // kTile = 16 positions a thread: every load issued before the adds.
    constexpr int kEach = kTile / kPlanThreads;
    int idx[kEach];
    T v[kEach];
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int q = lo + threadIdx.x + k * kPlanThreads;
      idx[k] = q < hi ? p.order[q] : 0;
    }
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int q = lo + threadIdx.x + k * kPlanThreads;
      v[k] = q < hi ? src(idx[k]) : T(0);
    }
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kEach; ++k) acc += v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      r = red[0];
#pragma unroll
      for (int w = 1; w < kPlanThreads / 32; ++w) r += red[w];
    }
  }
  if (n == 1) {
    // The other run is empty: r + 0 (or 0 + r) is r, which is never -0.
    if (threadIdx.x == 0) out[seg] = r;
    __syncthreads();  // red and buf are reused by the next tile
    return;
  }
  T* part = static_cast<T*>(p.partials);
  if (threadIdx.x == 0) {
    part[t] = r;
    __threadfence();
    last = atomicAdd(p.counts + first, 1) == n - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    T ra = T(0), rb = T(0);
    for (int k = first; k < first + na; ++k) ra += __ldcg(part + k);
    for (int k = first + na; k < first + n; ++k) rb += __ldcg(part + k);
    out[seg] = pair ? ra + rb : ra;
    p.counts[first] = 0;
  }
  __syncthreads();  // red, last and buf are reused by the next tile
}

// Units u of an exact plan (no tile list): a run, u = 2 s + half in a
// pair plan, u = s otherwise.  The block takes the units u = blockIdx.x,
// blockIdx.x + nblk, ... of segments with a run longer than kLaneMax,
// and sums each from 0 in index order (every nonempty run of such a
// segment, so that its units complete it).  A pair segment's two runs
// go to two blocks at once; the second to finish adds the two sums,
// first run first, from plan scratch (partials[2 s + half], counts[s]).
template <typename T>
__device__ void chain_units(const Src<T>& src, const Plan& p, T* out,
                            int nseg, bool pair, int nblk,
                            T (*buf)[kSeq + kLook]) {
  __shared__ int found[kPlanThreads][3];  // (unit, run start, run end)
  __shared__ int nfound;
  const int nunits = pair ? 2 * nseg : nseg;
  for (int pass = 0; pass * kPlanThreads * nblk < nunits; ++pass) {
    if (threadIdx.x == 0) nfound = 0;
    __syncthreads();
    const int u = (pass * kPlanThreads + threadIdx.x) * nblk + blockIdx.x;
    if (u < nunits) {
      const int seg = pair ? u >> 1 : u, half = pair ? u & 1 : 0;
      const int lo = p.offsets[seg], hi = p.offsets[seg + 1];
      const int mid = pair ? p.mid[seg] : hi;
      const int r0 = half ? mid : lo, r1 = half ? hi : mid;
      if ((mid - lo > kLaneMax || hi - mid > kLaneMax) && r1 > r0) {
        const int k = atomicAdd(&nfound, 1);
        found[k][0] = u;
        found[k][1] = r0;
        found[k][2] = r1;
      }
    }
    __syncthreads();
    const int n = nfound;
    for (int i = 0; i < n; ++i) {
      const int uu = found[i][0];
      const T r = seq_sum(src, p.order, found[i][1], found[i][2], buf);
      const int seg = pair ? uu >> 1 : uu;
      const int lo = p.offsets[seg], hi = p.offsets[seg + 1];
      const int mid = pair ? p.mid[seg] : hi;
      if (threadIdx.x == 0) {
        if (mid == lo || hi == mid) {
          // One run: r + 0 (or 0 + r) is r, which is never -0.
          out[seg] = r;
        } else {
          T* part = static_cast<T*>(p.partials);
          part[uu] = r;
          __threadfence();
          if (atomicAdd(p.counts + seg, 1) == 1) {
            __threadfence();
            out[seg] = __ldcg(part + 2 * seg) + __ldcg(part + 2 * seg + 1);
            p.counts[seg] = 0;
          }
        }
      }
      __syncthreads();  // buf and found are reused
    }
  }
}

// Blocks [0, work_blocks) are work blocks: tile blocks, which walk the
// plan's tile list (its used entries come first), or, for an exact plan
// (ntiles = 0), chain blocks (chain_units).  The rest are segment
// blocks, a thread a segment; a segment with a run longer than kLaneMax
// is left to the work blocks.
template <typename T>
__global__ void __launch_bounds__(kPlanThreads, 4)
    plan_kernel(Src<T> src, Plan p, T* __restrict__ out, int nseg,
                int work_blocks, int ntiles, bool pair) {
  __shared__ T buf[2][kSeq + kLook];
  if (static_cast<int>(blockIdx.x) < work_blocks) {
    if (ntiles == 0) {
      chain_units(src, p, out, nseg, pair, work_blocks, buf);
      return;
    }
    for (int t = blockIdx.x; t < ntiles; t += work_blocks) {
      if (p.tiles[static_cast<int64_t>(t) * kTileFields] < 0) break;
      tile_sum(src, p, out, pair, t, buf);
    }
    return;
  }
  const int s = (blockIdx.x - work_blocks) * kPlanThreads + threadIdx.x;
  if (s >= nseg) return;
  const int lo = p.offsets[s], hi = p.offsets[s + 1];
  const int mid = pair ? p.mid[s] : hi;
  if (mid - lo > kLaneMax || hi - mid > kLaneMax) return;
  const T ra = lane_seq(src, p.order, lo, mid);
  out[s] = pair ? ra + lane_seq(src, p.order, mid, hi) : ra;
}

template <typename T>
int launch_plan(const void* a, const void* b, int split, const Plan& p,
                int ntiles, void* out, int nseg, bool pair, cudaStream_t st) {
  const int seg_blocks = (nseg + kPlanThreads - 1) / kPlanThreads;
  // An exact plan: a chain block for each 32 units, at most kWorkBlocks.
  const int want = ntiles > 0 ? ntiles : ((pair ? 2 : 1) * nseg + 31) / 32;
  const int work_blocks = want < kWorkBlocks ? want : kWorkBlocks;
  const Src<T> src{static_cast<const T*>(a), static_cast<const T*>(b), split};
  plan_kernel<T><<<work_blocks + seg_blocks, kPlanThreads, 0, st>>>(
      src, p, static_cast<T*>(out), nseg, work_blocks, ntiles, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 int64.  Each entry point takes
// its arguments packed as int64 (pointers as addresses), which keeps
// the host's cost of a call low.
//
// segment_sum_scan: {data, labels (int64), out, L, nseg, dtype, stream,
// device}.
extern "C" int segment_sum_scan(const int64_t* args) {
  const void* data = reinterpret_cast<const void*>(args[0]);
  const int64_t* lab = reinterpret_cast<const int64_t*>(args[1]);
  void* out = reinterpret_cast<void*>(args[2]);
  const int64_t L = args[3], nseg = args[4];
  const int dtype = static_cast<int>(args[5]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[6]);
  if (nseg <= 0) return 0;
  cudaError_t err = cudaSetDevice(static_cast<int>(args[7]));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nb = (nseg + kThreads - 1) / kThreads;
  if (nb > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb));
  switch (dtype) {
    case 0:
      scan_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(data), lab, static_cast<float*>(out), L,
          nseg);
      break;
    case 1:
      scan_kernel<double><<<grid, kThreads, 0, st>>>(
          static_cast<const double*>(data), lab, static_cast<double*>(out),
          L, nseg);
      break;
    case 2:
      scan_kernel<long long><<<grid, kThreads, 0, st>>>(
          static_cast<const long long*>(data), lab,
          static_cast<long long*>(out), L, nseg);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// segment_sum_plan: a sum over a plan, {a, b, split, order, offsets, mid,
// tiles, ntiles, partials, counts, out, nseg, pair, dtype, stream,
// device}.  Single (pair = 0): out[s] = sum of a over segment s, split =
// L, mid = 0.  Pair (pair = 1): positions below split index a, the rest b
// at position - split, and out[s] = (a's sum) + (b's sum).  tiles holds
// ntiles descriptors.
extern "C" int segment_sum_plan(const int64_t* args) {
  const void* a = reinterpret_cast<const void*>(args[0]);
  const void* b = reinterpret_cast<const void*>(args[1]);
  const int split = static_cast<int>(args[2]);
  const Plan p{reinterpret_cast<const int32_t*>(args[3]),
               reinterpret_cast<const int32_t*>(args[4]),
               reinterpret_cast<const int32_t*>(args[5]),
               reinterpret_cast<const int32_t*>(args[6]),
               reinterpret_cast<void*>(args[8]),
               reinterpret_cast<int32_t*>(args[9])};
  const int ntiles = static_cast<int>(args[7]);
  void* out = reinterpret_cast<void*>(args[10]);
  const int nseg = static_cast<int>(args[11]);
  const bool pair = args[12] != 0;
  const int dtype = static_cast<int>(args[13]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[14]);
  if (nseg <= 0) return 0;
  cudaError_t err = cudaSetDevice(static_cast<int>(args[15]));
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0:
      return launch_plan<float>(a, b, split, p, ntiles, out, nseg, pair, st);
    case 1:
      return launch_plan<double>(a, b, split, p, ntiles, out, nseg, pair, st);
    case 2:
      return launch_plan<long long>(a, b, split, p, ntiles, out, nseg, pair,
                                    st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
