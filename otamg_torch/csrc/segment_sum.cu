// Deterministic segment sum for Hopper (sm_90a):
//   out[s] = sum of data[j] over the j with labels[j] == s,  0 <= s < nseg.
//
// Replaces jax.ops.segment_sum as the JAX package uses it in
// otamg/amg/graph.py and otamg/amg/hierarchy.py (component sizes, the
// per-component kernel projections of the smoother, the deflated
// means).  XLA lowers it to a scatter-add; the JAX package has no Pallas
// kernel for it.  PyTorch's index_add_ on the card adds with atomics in
// no fixed order, so two runs of one solve on the card took different
// paths; both variants here fix the order of every sum, and neither
// synchronises with the host, so the AMG cycle that calls them can be
// captured in a CUDA graph.
//
// Bound: each input is read once and out written once, L*(s + 8) +
// nseg*s bytes for L elements of s bytes, and one add per element, so
// the function is bound by memory traffic; at the sizes of the main path
// (L, nseg of a few thousand) a call is a few microseconds of latency.
//
// * scan (nseg * L small, the bipartite hierarchy of the OT solves).
//   Thread s owns segment s and walks over all L elements in index order,
//   staged tile by tile in shared memory, where every thread reads the
//   same element at once (a broadcast), adding those of its segment.  The
//   adds come in the order of the CPU's index_add_, so a sum on the card
//   equals the CPU's bit for bit.  No sort, one launch.
// * sorted (large inputs, the sparse levels, where one segment may hold
//   a million elements).  The wrapper sorts the labels (stable) and finds
//   each segment's run.  Pass 1 sums the sorted positions tile by tile
//   (2048 a block): a tile inside one segment by a fixed tree, otherwise
//   each run in order by one thread; pass 2, a thread per segment, adds
//   the tile sums of a segment that spans tiles in tile order.
//   Deterministic, though not in the CPU's order.
//
// C interface, loaded with ctypes: segment_sum_scan / segment_sum_sorted
// launch on the given stream and device, do not synchronise and return
// cudaGetLastError() (cudaErrorInvalidValue for a bad dtype code).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // elements staged in shared memory per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ data, const int64_t* __restrict__ labels,
                T* __restrict__ out, int64_t L, int64_t nseg) {
  __shared__ int32_t lab_s[kTile];
  __shared__ T val_s[kTile];
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  for (int64_t base = 0; base < L; base += kTile) {
    const int n = static_cast<int>(L - base < kTile ? L - base : kTile);
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

constexpr int kSortedTile = 2048;  // sorted positions per tile block

// Sorted variant, pass 1: block b owns sorted positions [b*T, b*T + T).
// A tile inside one segment is summed by a fixed tree; otherwise each run
// of equal labels is summed in order by the thread at its start.  A run
// that is a whole segment goes to out; each tile also keeps the sums of
// its first and its last run for pass 2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const T* __restrict__ data, const int64_t* __restrict__ order,
                const int64_t* __restrict__ sl, int64_t L,
                T* __restrict__ out, T* __restrict__ first_sum,
                T* __restrict__ last_sum) {
  __shared__ int64_t lab[kSortedTile];
  __shared__ T val[kSortedTile];
  __shared__ T red[kThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortedTile;
  const int n = static_cast<int>(L - base < kSortedTile ? L - base
                                                          : kSortedTile);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    lab[j] = sl[base + j];
    val[j] = data[order[base + j]];
  }
  __syncthreads();
  const bool starts0 = base == 0 || sl[base - 1] != lab[0];
  const bool endsn = base + n == L || sl[base + n] != lab[n - 1];
  if (lab[0] == lab[n - 1]) {
    T acc = T(0);
    for (int j = threadIdx.x; j < n; j += kThreads) acc += val[j];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      first_sum[blockIdx.x] = last_sum[blockIdx.x] = red[0];
      if (starts0 && endsn) out[lab[0]] = red[0];
    }
    return;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    if (j > 0 && lab[j] == lab[j - 1]) continue;  // not a run's start
    T acc = T(0);
    int e = j;
    for (; e < n && lab[e] == lab[j]; ++e) acc += val[e];
    if (j == 0) first_sum[blockIdx.x] = acc;
    if (e == n) last_sum[blockIdx.x] = acc;
    if ((j > 0 || starts0) && (e < n || endsn)) out[lab[j]] = acc;
  }
}

// Sorted variant, pass 2: one thread per segment.  An empty segment
// gets 0; one that spans tiles adds its first tile's last run, the
// tiles inside it and its last tile's first run, in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const int64_t* __restrict__ offsets,
                   const T* __restrict__ first_sum,
                   const T* __restrict__ last_sum, T* __restrict__ out,
                   int64_t nseg) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       s < nseg; s += stride) {
    const int64_t a = offsets[s];
    const int64_t b = offsets[s + 1];
    if (a == b) {
      out[s] = T(0);
      continue;
    }
    const int64_t ta = a / kSortedTile;
    const int64_t tb = (b - 1) / kSortedTile;
    if (ta == tb) continue;  // whole inside one tile: pass 1 wrote it
    T acc = last_sum[ta];
    for (int64_t t = ta + 1; t <= tb; ++t) acc += first_sum[t];
    out[s] = acc;
  }
}

int blocks_for(int64_t n, int per_block, int cap) {
  const int64_t b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 int64.
extern "C" int segment_sum_scan(const void* data, const void* labels,
                                void* out, int64_t L, int64_t nseg,
                                int dtype, void* stream, int device) {
  if (nseg <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nb = (nseg + kThreads - 1) / kThreads;
  if (nb > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
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

template <typename T>
int launch_sorted(const void* data, const void* order, const void* sorted,
                  const void* offsets, void* first, void* last, void* out,
                  int64_t L, int64_t nseg, cudaStream_t st) {
  const int64_t tiles = (L + kSortedTile - 1) / kSortedTile;
  if (tiles > 0)
    tile_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        static_cast<const T*>(data), static_cast<const int64_t*>(order),
        static_cast<const int64_t*>(sorted), L, static_cast<T*>(out),
        static_cast<T*>(first), static_cast<T*>(last));
  combine_kernel<T><<<blocks_for(nseg, kThreads, 132 * 8), kThreads, 0, st>>>(
      static_cast<const int64_t*>(offsets), static_cast<const T*>(first),
      static_cast<const T*>(last), static_cast<T*>(out), nseg);
  return static_cast<int>(cudaGetLastError());
}

// ``first`` and ``last`` hold one value per tile of 2048 sorted positions.
extern "C" int segment_sum_sorted(const void* data, const void* order,
                                  const void* sorted, const void* offsets,
                                  void* first, void* last, void* out,
                                  int64_t L, int64_t nseg, int dtype,
                                  void* stream, int device) {
  if (nseg <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_sorted<float>(data, order, sorted, offsets, first, last,
                                  out, L, nseg, st);
    case 1:
      return launch_sorted<double>(data, order, sorted, offsets, first, last,
                                   out, L, nseg, st);
    case 2:
      return launch_sorted<long long>(data, order, sorted, offsets, first,
                                      last, out, L, nseg, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
