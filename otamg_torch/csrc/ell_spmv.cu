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
//
// Design: one warp per row.  Lanes stride over the row's cap slots, so
// a warp reads cols and vals of its row coalesced; loads of x go through
// the read-only cache (__ldg); the row sum is a __shfl_down_sync
// reduction in the value type and lane 0 stores.  None of the TPU
// layout carries over (no 256-row blocks, no 128-wide capacity tiles,
// no 128-lane sweep over x).  Short rows waste lanes: a 5-point stencil
// (cap = 5) keeps 5 of 32 lanes busy, which a later kernel fixes by
// giving a warp several rows.
//
// C interface, loaded with ctypes: each entry point launches on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int32_t* __restrict__ cols,
                const T* __restrict__ vals,
                const T* __restrict__ x,
                T* __restrict__ y,
                int64_t nrows, int64_t cap, int64_t n) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;  // uniform across the warp
  const int32_t* c = cols + row * cap;
  const T* v = vals + row * cap;
  T acc = T(0);
  for (int64_t k = lane; k < cap; k += 32) {
    const int32_t j = c[k];
    const T xj = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
    acc += v[k] * xj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           int64_t nrows, int64_t cap, int64_t n, void* stream) {
  if (nrows > 0) {
    const int64_t blocks = (nrows * 32 + kThreads - 1) / kThreads;
    ell_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), nrows, cap, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols, const void* vals,
                            const void* x, void* y, int64_t nrows,
                            int64_t cap, int64_t n, void* stream) {
  return launch<float>(cols, vals, x, y, nrows, cap, n, stream);
}

extern "C" int ell_spmv_f64(const void* cols, const void* vals,
                            const void* x, void* y, int64_t nrows,
                            int64_t cap, int64_t n, void* stream) {
  return launch<double>(cols, vals, x, y, nrows, cap, n, stream);
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
