// ELL sparse matrix-vector product for Hopper (sm_90a):
//   y[i] = sum_r vals[i, r] * x[cols[i, r]],
// where a column c with c < 0 or c >= n contributes exactly 0.
//
// Replaces the TPU kernel otamg/sparse/kernels.py::_spmv_kernel (Pallas,
// launched by _pallas_spmv), with the same out-of-range rule.
//
// Bound: the kernel moves N*cap*(4 + s) bytes of cols and vals, N*s bytes
// of y and n*s bytes of x, s being the value size, and does 2*N*cap
// flops, so it is bound by HBM bandwidth:
//   t >= (N*cap*(4 + s) + N*s + n*s) / (3.35 TB/s on an H100 SXM).
// At 2 flops per 12-16 bytes it sits far under the ridge: tensor cores
// (wgmma) have nothing to do here, and none are used.  Random gathers of
// x cost a 32-byte sector each, which the bound does not count.
//
// Design: two variants of one kernel, picked by the Python wrapper from
// cap (otamg_torch/sparse/kernels.py::plan).
//
// * slab<G> (short rows, cap <= 32).  A block owns a run of rows whose
//   cols and vals are one contiguous slab of about 2048 elements.  A
//   persistent grid (as many blocks as are resident on all SMs, walking
//   over the slabs) copies each slab into shared memory with 16-byte
//   cp.async, double buffered so that the next slab's copy overlaps this
//   one's gathers.  The copy takes any element-aligned pointer: the
//   elements before the first 16-byte boundary and after the last are
//   copied one by one, so a row-sliced view such as cols[1:] works and
//   nothing outside the tensors is read.  G lanes serve one row (G = 1 up
//   to cap 16, 4 up to 32, the four summing with a shuffle), and
//   consecutive groups take consecutive rows, so y is stored as one
//   contiguous run.
// * warp (long rows, cap > 32).  One warp per row, lanes striding over
//   the row with four passes of cols/vals loads in flight before their
//   gathers; the matrix is streamed (__ldcs) so that x keeps L2.  Rows
//   this long gather x at random in the operators measured, and the
//   gathers, one 32-byte L2 sector each, bound the time, not the matrix
//   bytes: 16-byte vector loads of cols and vals were tried and gained
//   nothing in f64.
//
// x goes through the read-only cache (__ldg) in both.  The boundaries
// and the group sizes were set by measurement on an H100 80GB HBM3 at
// 700 W with ell_spmv_sweep.py (PERF.md, Findings PR 2): slab<1> leads
// on the stencils of cap 1 to 9 and on random rows of 16, slab<4> on
// the 27-point stencil, a warp per row on random rows of 33 and more.
//
// C interface, loaded with ctypes: ell_spmv_launch launches on the given
// stream and device, does not synchronise and returns cudaGetLastError()
// (or cudaErrorInvalidValue / cudaErrorMisalignedAddress for bad
// arguments).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kSlabElems = 2048;  // target rows*cap of one slab
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <int B>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Elements of U before the first 16-byte boundary at or after p.
template <typename U>
__device__ __forceinline__ int lead(const U* p) {
  return static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / sizeof(U));
}

// Index in a slab buffer of the slab's first element: chosen so that the
// first 16-byte-aligned element of the source lands on a 16-byte
// boundary of the buffer (buffers hold len + 16/sizeof(U) - 1 elements).
template <typename U>
__device__ __forceinline__ int slab_offset(const U* p) {
  constexpr int V = 16 / sizeof(U);
  return (V - lead(p)) & (V - 1);
}

// Copies src[0, len) into buf[off, off + len) with cp.async (not
// committed): 16-byte chunks for the aligned body, single elements for
// the head and the tail.
template <typename U>
__device__ __forceinline__ void stage_slab(U* buf, const U* src, int len) {
  constexpr int V = 16 / sizeof(U);
  const int lead_n = lead(src);
  const int head = lead_n < len ? lead_n : len;
  U* dst = buf + slab_offset(src);
  const int body = (len - head) / V;
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(dst + head + i * V, src + head + i * V);
  const int tail0 = head + body * V;
  const int t = threadIdx.x;
  if (t < head) cp_async_small<sizeof(U)>(dst + t, src + t);
  if (t < len - tail0)
    cp_async_small<sizeof(U)>(dst + tail0 + t, src + tail0 + t);
}

// Row sums of one slab held in shared memory; G lanes per row.
template <typename T, int G>
__device__ __forceinline__ void slab_rows(const int32_t* cs, const T* vs,
                                          const T* __restrict__ x,
                                          T* __restrict__ y, int nr,
                                          int tile_rows, int cap, int n) {
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x / G;
  const int l = threadIdx.x % G;
  for (int rb = 0; rb < tile_rows; rb += kGroups) {
    const int r = rb + g;
    T acc = T(0);
    if (r < nr) {
      const int32_t* c = cs + r * cap;
      const T* v = vs + r * cap;
#pragma unroll 4
      for (int k = l; k < cap; k += G) {
        const int32_t j = c[k];
        const T xj = static_cast<uint32_t>(j) < static_cast<uint32_t>(n)
                         ? __ldg(x + j)
                         : T(0);
        acc += v[k] * xj;
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
    if (l == 0 && r < nr) y[r] = acc;
  }
}

// Elements of one stage's buffer: the slab, up to 16/sizeof - 1 leading
// slots (slab_offset), rounded up to whole 16-byte chunks.
__host__ __device__ constexpr int slab_stride_cols(int elems) {
  return (elems + 3 + 3) & ~3;
}

template <typename T>
__host__ __device__ constexpr int slab_stride_vals(int elems) {
  constexpr int V = 16 / sizeof(T);
  return (elems + V - 1 + V - 1) / V * V;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmv_slab(const int32_t* __restrict__ cols, const T* __restrict__ vals,
              const T* __restrict__ x, T* __restrict__ y, int64_t nrows,
              int cap, int n, int tile_rows, int64_t ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int elems = tile_rows * cap;
  const int cstride = slab_stride_cols(elems);
  const int vstride = slab_stride_vals<T>(elems);
  int32_t* cbuf = reinterpret_cast<int32_t*>(smem);
  T* vbuf = reinterpret_cast<T*>(smem + 2 * cstride * sizeof(int32_t));

  auto stage = [&](int64_t t, int st) {
    const int64_t r0 = t * tile_rows;
    const int nr = static_cast<int>(
        nrows - r0 < tile_rows ? nrows - r0 : tile_rows);
    const int64_t e0 = r0 * cap;
    stage_slab(cbuf + st * cstride, cols + e0, nr * cap);
    stage_slab(vbuf + st * vstride, vals + e0, nr * cap);
  };

  int64_t t = blockIdx.x;
  if (t < ntiles) stage(t, 0);
  cp_async_commit();
  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    const int st = it & 1;
    if (t + gridDim.x < ntiles) stage(t + gridDim.x, st ^ 1);
    cp_async_commit();     // possibly empty: keeps one group per tile
    cp_async_wait_prior();  // this thread's copies of tile t are done
    __syncthreads();        // and everyone's
    const int64_t r0 = t * tile_rows;
    const int64_t e0 = r0 * cap;
    const int nr = static_cast<int>(
        nrows - r0 < tile_rows ? nrows - r0 : tile_rows);
    slab_rows<T, G>(cbuf + st * cstride + slab_offset(cols + e0),
                    vbuf + st * vstride + slab_offset(vals + e0), x, y + r0,
                    nr, tile_rows, cap, n);
    __syncthreads();  // before the next iteration overwrites stage st
  }
}

template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, int32_t j,
                                    int n) {
  return static_cast<uint32_t>(j) < static_cast<uint32_t>(n) ? __ldg(x + j)
                                                              : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_warp(const int32_t* __restrict__ cols, const T* __restrict__ vals,
              const T* __restrict__ x, T* __restrict__ y, int64_t nrows,
              int64_t cap, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t row =
           (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       row < nrows; row += warps) {  // uniform across the warp
    const int32_t* c = cols + row * cap;
    const T* v = vals + row * cap;
    T acc = T(0);
    for (int64_t b = lane; b < cap; b += 128) {
      int32_t cc[4];
      T vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t k = b + 32 * u;
        cc[u] = k < cap ? __ldcs(c + k) : -1;
        vv[u] = k < cap ? __ldcs(v + k) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += vv[u] * gather(x, cc[u], n);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) y[row] = acc;
  }
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <typename T, int G>
int launch_slab(const int32_t* cols, const T* vals, const T* x, T* y,
                int64_t nrows, int cap, int n, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int per = cap > 0 ? kSlabElems / cap : kSlabElems;
  const int tile_rows = per >= kGroups ? per / kGroups * kGroups : kGroups;
  const int elems = tile_rows * cap;
  if (elems > 4 * kSlabElems) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      2 * (slab_stride_cols(elems) * sizeof(int32_t) +
           slab_stride_vals<T>(elems) * sizeof(T));
  // Resident blocks per SM for the last shared-memory size seen.
  static size_t known_smem = 0, allowed_smem = 48 * 1024;
  static int per_sm = 0;
  if (smem > allowed_smem) {
    cudaFuncSetAttribute(ell_spmv_slab<T, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    allowed_smem = smem;
  }
  if (smem != known_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_spmv_slab<T, G>,
                                                  kThreads, smem);
    known_smem = smem;
  }
  const int64_t ntiles = (nrows + tile_rows - 1) / tile_rows;
  const int64_t resident =
      static_cast<int64_t>(sm_count()) * (per_sm > 1 ? per_sm : 1);
  const int64_t blocks = ntiles < resident ? ntiles : resident;
  ell_spmv_slab<T, G><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(cols, vals, x, y, nrows, cap, n, tile_rows,
                                  ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_warp(const int32_t* cols, const T* vals, const T* x, T* y,
                int64_t nrows, int64_t cap, int n, cudaStream_t stream) {
  const int64_t want = (nrows * 32 + kThreads - 1) / kThreads;
  const int64_t blocks = want < (1 << 30) ? want : (1 << 30);
  ell_spmv_warp<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(cols, vals, x, y, nrows, cap, n);
  return static_cast<int>(cudaGetLastError());
}

// variant: 1 or 4 = slab<G>; 0 = warp.  Must agree with
// kernels.py::plan.
template <typename T>
int launch(const void* cols_, const void* vals_, const void* x_, void* y_,
           int64_t nrows, int64_t cap, int64_t n, int64_t variant,
           cudaStream_t stream) {
  const auto* cols = static_cast<const int32_t*>(cols_);
  const auto* vals = static_cast<const T*>(vals_);
  const auto* x = static_cast<const T*>(x_);
  auto* y = static_cast<T*>(y_);
  if (nrows < 0 || cap < 0 || n < 0 || n > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(cols_) % sizeof(int32_t) ||
      reinterpret_cast<uintptr_t>(vals_) % sizeof(T) ||
      reinterpret_cast<uintptr_t>(x_) % sizeof(T) ||
      reinterpret_cast<uintptr_t>(y_) % sizeof(T))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (nrows == 0) return static_cast<int>(cudaGetLastError());
  const int ni = static_cast<int>(n);
  if (variant > 0 && cap > 4 * kSlabElems)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ci = static_cast<int>(cap);
  switch (variant) {
    case 1: return launch_slab<T, 1>(cols, vals, x, y, nrows, ci, ni, stream);
    case 4: return launch_slab<T, 4>(cols, vals, x, y, nrows, ci, ni, stream);
    case 0: return launch_warp<T>(cols, vals, x, y, nrows, cap, ni, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch.  `packed` holds 11 native int64: the addresses of cols,
// vals, x and y, nrows, cap, n (the length of x), the variant, the
// stream, the device and the value size (4 or 8).  One block of bytes
// keeps the Python side's per-call cost to a single ctypes argument.
extern "C" int ell_spmv_launch(const char* packed) {
  int64_t a[11];
  memcpy(a, packed, sizeof a);
  const auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != a[9])
    e = cudaSetDevice(static_cast<int>(a[9]));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto stream = static_cast<cudaStream_t>(p(8));
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (a[10] == 4)
    err = launch<float>(p(0), p(1), p(2), p(3), a[4], a[5], a[6], a[7],
                        stream);
  else if (a[10] == 8)
    err = launch<double>(p(0), p(1), p(2), p(3), a[4], a[5], a[6], a[7],
                         stream);
  if (prev != a[9]) cudaSetDevice(prev);
  return err;
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
