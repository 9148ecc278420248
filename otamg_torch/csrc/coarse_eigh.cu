// Eigendecomposition of the AMG hierarchy's coarsest dense level for
// Hopper (sm_90a), in one launch of one block: Householder
// tridiagonalisation, multisection on Sturm counts, inverse iteration,
// back-transformation.
//
// Replaces jnp.linalg.eigh in otamg/amg/hierarchy.py::_build_dense_chain
// (no Pallas kernel: XLA's eigh inside the jit).  torch.linalg.eigh runs
// cuSOLVER's syevd, whose info PyTorch checks with a host sync, so the
// setup around it could not be captured in a CUDA graph, and cuSOLVER
// itself refuses a stream capture (scripts/cusolver_capture_probe.py).
// Here every decision and info stay on the card.  The method is
// tests/eigh_steps.py::coarse_eigh_steps_plain, step by step:
//
// 1. Tridiagonalisation (LAPACK xSYTD2, lower).  The lower triangle
//    lives in shared memory (layout 0) or in the global workspace
//    (layout 1), rows n | 1 values apart so that a warp reading a
//    column hits 32 banks.  Warp 0 forms the reflector of column k (norm
//    by warp shuffles; v is kept in the column, v[0] = 1 stored, and
//    copied to row k's unused upper part, where it is contiguous).  A
//    nontrivial step is three barriers: p = tau A22 v (eight partial
//    sums a row, two FMA chains each), p combined, then w = p - tau/2
//    (p.v) v and A22 -= v w^T + w v^T on the lower triangle, while warp
//    0 updates column k + 1 alone and forms the next reflector from it.
//    Reflectors that are the identity (a zero column, as the coarsest
//    level's inactive nodes give) change nothing, so warp 0 forms a run
//    of them with no barrier between.
// 2. xSTEBZ's splitting (e_i = 0 where e_i^2 <= |d_i d_i+1| ulp^2 +
//    safemin): the inactive nodes become 1x1 blocks, whose eigenpairs
//    are read off (at Class-1 500^2, 111 blocks of n = 123).
// 3. Eigenvalues block by block: four lanes an eigenvalue, eight
//    eigenvalues a warp; each round the lanes count at four evenly
//    spaced points and the ballot keeps the fifth of the interval that
//    holds the eigenvalue, until its width is under xSTEBZ's max(ulp
//    tnorm, pivmin, 2 ulp max(|lo|, |hi|)) or stops shrinking.  The
//    count's quotient is the reciprocal's approximation and two Newton
//    steps in f64 (a few ulps, as a rounded division).
// 4. Eigenvectors (xSTEIN): a thread a shift, perturbed within 10 eps
//    |x| of the one below as xSTEIN does; xLAGTF's LU with partial
//    pivoting of T_b - x I into the workspace (with U's reciprocals),
//    then solves (xLAGTS, job -1, its growth of a pivot whose quotient
//    would overflow) from a hashed start vector scaled as xSTEIN scales
//    it, until the growth test has passed EXTRA + 1 times; the loads of
//    four rows are issued together.  Then one warp a cluster
//    (neighbouring shifts within 1e-3 ||T_b||_1) orthogonalises its
//    vectors in order by modified Gram-Schmidt, twice; a vector left
//    with under 1/16 of its norm is solved once more from what is left
//    (at most three times).  Eigenvalues are ranked (ties by index) and
//    each vector goes to its column of V.
// 5. Back-transformation V = H_0 ... H_n-3 Z: a warp owns columns of V
//    and holds them in registers (8, 16 or 32 lanes a column, up to 16
//    rows a lane), applying every nontrivial reflector from its row
//    copy with no barrier; past n = 512 a warp a column from global
//    memory.
//
// info is 1 if a multisection or an inverse iteration did not converge,
// or a clustered vector kept no norm; else 0.
//
// Bound: ~(4/3) n^3 flops to tridiagonalise and 2 n^3 to back-transform
// (the Sturm counts and the inverse iteration are O(n^2) a round or a
// vector; chip_smoke.py's bound counts (10/3) n^3 at 67 TFLOP/s, f64 on
// DMMA), 2 n^2 values moved; at the path's sizes one block is latency: each step of
// the reduction and each thread's inverse iteration is a chain of
// dependent shared-memory loads and f64 operations, and each
// multisection round an n-step recurrence.  The kernel runs on one SM
// with 512 threads (128 registers each).
//
// C interface, loaded with ctypes: coarse_eigh_launch takes its
// arguments packed in one int64 array, launches on the given stream and
// device, does not synchronise and returns cudaGetLastError().
//
// Built with -DEIGH_STAMPS (scripts/eigh_phase_profile.py), thread 0
// writes clock64() after each phase's barrier into the eight int64s at
// args[11]; the port's build has no stamps and reads 11 arguments.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;       // points a multisection round tests
constexpr int kMaxRounds = 64;  // rounds before info = 1
constexpr int kMaxIts = 5;      // inverse iterations before info = 1
constexpr int kExtra = 1;       // iterations after the growth test passes
constexpr int kRetries = 3;     // solves that may restore a clustered vector
constexpr int kGroups = 8;      // partial sums a row of p = A22 v

#ifdef EIGH_STAMPS
__device__ long long* g_stamps;
#define EIGH_STAMP(i) \
  if (threadIdx.x == 0) g_stamps[i] = clock64()
#else
#define EIGH_STAMP(i)
#endif

template <typename T>
struct Num;
template <>
struct Num<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
};
template <>
struct Num<float> {
  static constexpr float eps = 1.1920928955078125e-07f;
  static constexpr float tiny = 1.1754943508222875e-38f;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The start vector of slot s at row r: a murmur3 finaliser, 24 bits to
// [-1, 1) (tests/eigh_steps.py::_start_vector).
template <typename T>
__device__ __forceinline__ T start_value(int r, int s) {
  uint32_t h = static_cast<uint32_t>(r) * 2654435761u +
               static_cast<uint32_t>(s) * 2246822519u + 3266489917u;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return static_cast<T>(h >> 8) * static_cast<T>(1.0 / 8388608.0) - T(1);
}

// The state a block keeps in shared memory (eigh_layout's 15 n values
// and five ints a row), each array found from the base when used, so
// that no phase holds fourteen pointers in registers.
template <typename T>
struct Shared {
  T* base;
  int n;
  __device__ T* d() const { return base; }
  __device__ T* e() const { return base + n; }
  __device__ T* e2() const { return base + 2 * n; }
  __device__ T* tau() const { return base + 3 * n; }
  __device__ T* lam() const { return base + 4 * n; }
  __device__ T* xs() const { return base + 5 * n; }
  __device__ T* p() const { return base + 6 * n; }
  __device__ T* part() const { return base + 7 * n; }  // kGroups n
  __device__ int* first() const {
    return reinterpret_cast<int*>(base + 15 * n);
  }
  __device__ int* last() const { return first() + n; }
  __device__ int* rank() const { return first() + 2 * n; }
  __device__ int* cls() const { return first() + 3 * n; }
  __device__ int* cle() const { return first() + 4 * n; }
  __device__ int* misc() const { return first() + 5 * n; }
};

// The inverse iteration's factors of one shift, rows of the block
// strided by n (kernels.py::_factor's u, u1, u2, l, piv, and 1 / u).
template <typename T>
struct Factors {
  T *u, *u1, *u2, *l, *r;  // r: U's diagonal's reciprocals
  unsigned char* piv;
};

// The row stride of the matrix: n rounded up to an odd number, so that
// a warp reading a column (lanes on neighbouring rows) hits 32 banks.
__host__ __device__ __forceinline__ int stride_of(int n) { return n | 1; }

// Warp 0 forms the reflector of column k from a[k+1:, k] (xLARFG) and
// keeps v there (v[0] = 1 stored) and in row k's unused upper part,
// where it is contiguous.  With have_ss the lanes bring their partial
// sums of x[2:]^2 (warp 0 has just written the column).  Returns tau.
template <typename T>
__device__ T form_reflector(T* a, int n, int ld, int k, const Shared<T> s,
                            T ss = 0, bool have_ss = false) {
  const int lane = threadIdx.x & 31;
  T* x = a + (k + 1) * ld + k;
  const int m = n - k - 1;
  __syncwarp();
  const T alpha = x[0];
  if (!have_ss) {
    for (int r = 1 + lane; r < m; r += 32) {
      const T xr = x[r * ld];
      ss += xr * xr;
    }
  }
  ss = warp_sum(ss);
  T t = 0, beta = alpha;
  if (ss != T(0)) {
    beta = -copysign(sqrt(alpha * alpha + ss), alpha);
    t = (beta - alpha) / beta;
    const T sc = T(1) / (alpha - beta);
    T* row = a + k * ld + k + 1;
    for (int r = 1 + lane; r < m; r += 32) {
      T* xr = x + r * ld;
      row[r] = *xr = *xr * sc;
    }
    if (lane == 0) x[0] = row[0] = T(1);
  }
  if (lane == 0) {
    s.d()[k] = a[k * ld + k];
    s.e()[k] = beta;
    s.tau()[k] = t;
  }
  return t;
}

// Warp 0: the reflectors from k on, up to and with the first that is not
// the identity (those before it change nothing, so no barrier falls
// between them); returns its index, or n - 2 when none is left.
template <typename T>
__device__ int form_until_nontrivial(T* a, int n, int ld, int k,
                                     const Shared<T> s) {
  const int lane = threadIdx.x & 31;
  for (; k + 2 < n; ++k) {
    // A zero column below the subdiagonal is told by one vote.
    const T* x = a + (k + 1) * ld + k;
    bool nz = false;
    for (int r = 1 + lane; r < n - k - 1; r += 32) nz |= x[r * ld] != T(0);
    if (__any_sync(kFull, nz)) {
      if (form_reflector(a, n, ld, k, s) != T(0)) break;
    } else if (lane == 0) {
      s.d()[k] = a[k * ld + k];
      s.e()[k] = x[0];
      s.tau()[k] = 0;
    }
  }
  return k;
}

// xSYTD2 (lower) on the lower triangle of a (row stride ld): d, e, tau
// into shared memory, v_k in column k below the diagonal and in row k
// above it.  A nontrivial step k: p = tau A22 v (kGroups partial sums a
// row, then combined), w = p - tau/2 (p.v) v, A22 -= v w^T + w v^T on
// the lower triangle; warp 0 updates column k + 1 alone and forms the
// next reflectors from it while the other warps update the rest.
template <typename T>
__device__ void tridiagonalize(T* a, int n, int ld, const Shared<T> s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kRowLanes = kThreads / kGroups;
  int* next_k = s.misc() + 2;
  if (warp == 0) {
    const int k = form_until_nontrivial(a, n, ld, 0, s);
    if (lane == 0) *next_k = k;
  }
  __syncthreads();
  for (;;) {
    const int k = *next_k;
    if (k + 2 >= n) break;
    const T t = s.tau()[k];
    const int m = n - k - 1;
    const T* __restrict__ vb = a + k * ld + k + 1;
    T* a22 = a + (k + 1) * ld + k + 1;
    {
      const int g = tid / kRowLanes, il = tid % kRowLanes;
      for (int i = il; i < m; i += kRowLanes) {
        // A22[i][j] is row i's entry left of the diagonal, column i's on
        // and below it.
        T acc0 = 0, acc1 = 0;  // two chains of FMAs
        const T* __restrict__ row = a22 + i * ld;
        int j = g;
        for (; j + kGroups < i; j += 2 * kGroups) {
          acc0 += row[j] * vb[j];
          acc1 += row[j + kGroups] * vb[j + kGroups];
        }
        if (j < i) {
          acc0 += row[j] * vb[j];
          j += kGroups;
        }
        const T* __restrict__ col = a22 + i;
        for (; j + kGroups < m; j += 2 * kGroups) {
          acc0 += col[j * ld] * vb[j];
          acc1 += col[(j + kGroups) * ld] * vb[j + kGroups];
        }
        if (j < m) acc0 += col[j * ld] * vb[j];
        s.part()[g * n + i] = acc0 + acc1;
      }
    }
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      T acc = 0;
      for (int g = 0; g < kGroups; ++g) acc += s.part()[g * n + i];
      s.p()[i] = t * acc;
    }
    __syncthreads();
    const T* __restrict__ p = s.p();
    T c = 0;
    for (int i = lane; i < m; i += 32) c += p[i] * vb[i];
    c = T(0.5) * t * warp_sum(c);
    if (warp == 0) {
      // Column k + 1 (A22's column 0), then the next reflectors.
      const T w0 = p[0] - c * vb[0];
      T ss = 0;  // the next reflector's sum of squares, rows 2 on
      for (int i = lane; i < m; i += 32) {
        const T vi = vb[i], wi = p[i] - c * vi;
        T& x = a22[i * ld];
        const T xi = fma(-vi, w0, fma(-wi, vb[0], x));
        x = xi;
        if (i >= 2) ss += xi * xi;
      }
      int kn = k + 1;
      if (k + 3 < n && form_reflector(a, n, ld, k + 1, s, ss, true) == T(0))
        kn = form_until_nontrivial(a, n, ld, k + 2, s);
      if (lane == 0) *next_k = kn;
    } else {
      for (int i = warp; i < m; i += kWarps - 1) {
        const T vi = vb[i], wi = p[i] - c * vi;
        T* __restrict__ row = a22 + i * ld;
#pragma unroll 4
        for (int j = 1 + lane; j <= i; j += 32) {
          const T vj = vb[j], wj = p[j] - c * vj;
          row[j] = fma(-vi, wj, fma(-wi, vj, row[j]));
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (n >= 2) {
      s.d()[n - 2] = a[(n - 2) * ld + n - 2];
      s.e()[n - 2] = a[(n - 1) * ld + n - 2];
    }
    s.d()[n - 1] = a[(n - 1) * ld + n - 1];
    s.e()[n - 1] = 0;
  }
}

// e2 / q to a few ulps: the reciprocal's approximation and two Newton
// steps in f64, the fast division in f32.  The count stays the exact
// count of a matrix within a few ulps of T, as with a rounded division.
__device__ __forceinline__ double quot(double e2, double q) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(q));
  r = fma(r, fma(-q, r, 1.0), r);
  r = fma(r, fma(-q, r, 1.0), r);
  return e2 * r;
}
__device__ __forceinline__ float quot(float e2, float q) {
  return __fdividef(e2, q);
}

// xSTEBZ's count of the eigenvalues of the block b0..b1 at or below x.
// |q| >= pivmin keeps every quotient's divisor normal.
template <typename T>
__device__ int sturm(const Shared<T> s, int b0, int b1, T x, T pivmin) {
  const T* d = s.d();
  const T* e2 = s.e2();
  T q = d[b0] - x;
  if (fabs(q) < pivmin) q = -pivmin;
  int cnt = q <= T(0);
  for (int i = b0 + 1; i <= b1; ++i) {
    q = (d[i] - quot(e2[i - 1], q)) - x;
    if (fabs(q) < pivmin) q = -pivmin;
    cnt += q <= T(0);
  }
  return cnt;
}

template <typename T>
__device__ void bisect(int n, T pivmin, const Shared<T> s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T ulp = Num<T>::eps;
  const int l = lane % kLanes;
  constexpr int kSlots = 32 / kLanes;
  for (int base = warp * kSlots; base < n; base += kWarps * kSlots) {
    const int sl = base + lane / kLanes;
    bool done = true;
    int b0 = 0, b1 = 0;
    T lo = 0, hi = 0, atol = 0;
    if (sl < n) {
      b0 = s.first()[sl];
      b1 = s.last()[sl];
      if (b0 == b1) {
        if (l == 0) s.lam()[sl] = s.d()[sl];
      } else {
        T gl = s.d()[b0], gu = s.d()[b0];
        for (int i = b0; i <= b1; ++i) {
          const T r = (i > b0 ? fabs(s.e()[i - 1]) : T(0)) + fabs(s.e()[i]);
          gl = fmin(gl, s.d()[i] - r);
          gu = fmax(gu, s.d()[i] + r);
        }
        const T tnorm = fmax(fabs(gl), fabs(gu));
        atol = fmax(ulp * tnorm, pivmin);
        const T nb = static_cast<T>(b1 - b0 + 1);
        lo = gl - (T(2.1) * tnorm * ulp * nb + T(2.1) * 2 * pivmin);
        hi = gu + (T(2.1) * tnorm * ulp * nb + T(2.1) * pivmin);
        done = false;
      }
    }
    const bool live = !done;
    const int kk = sl - b0;
    for (int round = 0;; ++round) {
      if (!done && hi - lo < fmax(2 * ulp * fmax(fabs(lo), fabs(hi)), atol))
        done = true;
      if (!done && round == kMaxRounds) {
        done = true;
        s.misc()[0] = 1;
      }
      if (__all_sync(kFull, done)) break;
      const T w = (hi - lo) / T(kLanes + 1);
      int cnt = 0;
      if (!done) cnt = sturm(s, b0, b1, fma(T(l + 1), w, lo), pivmin);
      const unsigned above = __ballot_sync(kFull, !done && cnt > kk);
      if (!done) {
        const unsigned mine = (above >> (lane - l)) & ((1u << kLanes) - 1);
        const int at = mine ? __ffs(mine) - 1 : kLanes;
        const T nlo = at == 0 ? lo : fma(T(at), w, lo);
        const T nhi = at == kLanes ? hi : fma(T(at + 1), w, lo);
        if (nlo == lo && nhi == hi) done = true;
        lo = nlo;
        hi = nhi;
      }
    }
    if (live && l == 0) s.lam()[sl] = T(0.5) * (lo + hi);
  }
}

// ||T_b||_1 of the block b0..b1.
template <typename T>
__device__ T block_norm(const Shared<T> s, int b0, int b1, int from,
                        int step) {
  T nrm = 0;
  for (int i = b0 + from; i <= b1; i += step)
    nrm = fmax(nrm, fabs(s.d()[i]) + (i > b0 ? fabs(s.e()[i - 1]) : T(0)) +
                        fabs(s.e()[i]));
  return nrm;
}

// xLAGTF: the LU of T_b - x I with partial pivoting into f (rows of the
// block strided by n).  Returns xLAGTS's tolerance, eps times the
// largest entry of U; u_last gets U's last pivot.
template <typename T>
__device__ T factor(const Shared<T> s, int b0, int nb, T x, int n,
                    Factors<T> f, T& u_last) {
  T a = s.d()[b0] - x;
  T b = s.e()[b0];
  T scale1 = fabs(a) + fabs(b);
  T big = 0;
  for (int r = 0; r + 1 < nb; ++r) {
    const T c = s.e()[b0 + r];
    const T an = s.d()[b0 + r + 1] - x;
    const T bn = r + 2 < nb ? s.e()[b0 + r + 1] : T(0);
    const T scale2 = fabs(c) + fabs(an) + fabs(bn);
    const T piv1 = a == T(0) ? T(0) : fabs(a) / scale1;
    const T piv2 = fabs(c) / scale2;
    const size_t at = static_cast<size_t>(r) * n;
    T ur, u1r, u2r;
    if (piv2 <= piv1) {
      const T lr = c / a;
      ur = a;
      u1r = b;
      u2r = 0;
      f.l[at] = lr;
      f.piv[at] = 0;
      scale1 = scale2;
      a = an - lr * b;
      b = bn;
    } else {
      const T mult = a / c;
      ur = c;
      u1r = an;
      u2r = bn;
      f.l[at] = mult;
      f.piv[at] = 1;
      a = b - mult * an;
      b = -mult * bn;
    }
    f.u[at] = ur;
    f.r[at] = T(1) / ur;
    f.u1[at] = u1r;
    f.u2[at] = u2r;
    big = fmax(big, fmax(fabs(ur), fmax(fabs(u1r), fabs(u2r))));
  }
  const size_t at = static_cast<size_t>(nb - 1) * n;
  f.u[at] = a;
  f.r[at] = T(1) / a;
  f.u1[at] = 0;
  f.u2[at] = 0;
  u_last = a;
  big = fmax(big, fabs(a));
  const T tol = Num<T>::eps * big;
  return tol == T(0) ? Num<T>::eps : tol;
}

// xLAGTS (job -1) on y (rows strided by n), after scaling it by alpha:
// L's swaps and multipliers, then U with xLAGTS's growth of a pivot
// whose quotient would overflow.  With hash >= 0 the right-hand side is
// slot hash's start vector instead of y.  Returns max |x|; jmax gets the
// first row of that maximum and top its value.
template <typename T>
__device__ T solve(T* y, int nb, int n, Factors<T> f, T tol, T alpha,
                   int hash, int b0, int& jmax, T& top) {
  constexpr int kChunk = 4;  // rows whose loads are issued together
  const T tiny = Num<T>::tiny, big = T(1) / Num<T>::tiny;
  T prev = (hash >= 0 ? start_value<T>(b0, hash) : y[0]) * alpha;
  for (int r0 = 1; r0 < nb; r0 += kChunk) {
    T yv[kChunk], lv[kChunk];
    bool pv[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int r = r0 + q;
      if (r < nb) {
        const size_t at = static_cast<size_t>(r) * n;
        yv[q] = hash >= 0 ? start_value<T>(b0 + r, hash) : y[at];
        lv[q] = f.l[at - n];
        pv[q] = f.piv[at - n];
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int r = r0 + q;
      if (r < nb) {
        const T yr = yv[q] * alpha;
        T* out = y + static_cast<size_t>(r - 1) * n;
        if (!pv[q]) {
          *out = prev;
          prev = yr - lv[q] * prev;
        } else {
          *out = yr;
          prev = prev - lv[q] * yr;
        }
      }
    }
  }
  y[static_cast<size_t>(nb - 1) * n] = prev;
  T x1 = 0, x2 = 0, xmax = 0;
  for (int r0 = nb - 1; r0 >= 0; r0 -= kChunk) {
    T yv[kChunk], uv[kChunk], rv[kChunk], u1v[kChunk], u2v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int r = r0 - q;
      if (r >= 0) {
        const size_t at = static_cast<size_t>(r) * n;
        yv[q] = y[at];
        uv[q] = f.u[at];
        rv[q] = f.r[at];
        u1v[q] = f.u1[at];
        u2v[q] = f.u2[at];
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int r = r0 - q;
      if (r >= 0) {
        T t = yv[q];
        if (r + 1 < nb) t -= u1v[q] * x1;
        if (r + 2 < nb) t -= u2v[q] * x2;
        T ak = uv[q];
        T xr;
        if (fabs(ak) < T(1) && (fabs(ak) < tiny || fabs(t) > fabs(ak) * big)) {
          T pert = ak >= T(0) ? tol : -tol;
          for (;;) {
            const T aa = fabs(ak);
            if (aa >= T(1)) break;
            if (aa < tiny) {
              if (aa == T(0) || fabs(t) * tiny > aa) {
                ak += pert;
                pert *= 2;
                continue;
              }
              t *= big;
              ak *= big;
              break;
            }
            if (fabs(t) > aa * big) {
              ak += pert;
              pert *= 2;
              continue;
            }
            break;
          }
          xr = t / ak;
        } else {
          xr = t * rv[q];  // no pivot grows: the stored reciprocal
        }
        y[static_cast<size_t>(r) * n] = xr;
        x2 = x1;
        x1 = xr;
        if (fabs(xr) >= xmax) {
          xmax = fabs(xr);
          jmax = r;
          top = xr;
        }
      }
    }
  }
  return xmax;
}

// Phase A: slot sl's eigenvector by inverse iteration, its own shift
// alone, unit norm with its first largest entry positive, into column
// rank[sl] of V.
template <typename T>
__device__ void slot_vector(int sl, int n, T* V, Factors<T> f0, T* ys,
                            const Shared<T> s) {
  const int b0 = s.first()[sl], b1 = s.last()[sl], nb = b1 - b0 + 1;
  const int col = s.rank()[sl];
  if (nb == 1) {
    V[static_cast<size_t>(b0) * n + col] = T(1);
    return;
  }
  const size_t base = static_cast<size_t>(b0) * n + sl;
  Factors<T> f{f0.u + base, f0.u1 + base, f0.u2 + base, f0.l + base,
               f0.r + base, f0.piv + base};
  T* y = ys + base;
  const T onenrm = block_norm(s, b0, b1, 0, 1);
  const T dtpcrt = sqrt(T(0.1) / static_cast<T>(nb));
  T u_last;
  const T tol = factor(s, b0, nb, s.xs()[sl], n, f, u_last);
  const T scl = static_cast<T>(nb) * onenrm * fmax(Num<T>::eps, fabs(u_last));
  T bmax = 0;
  for (int r = 0; r < nb; ++r)
    bmax = fmax(bmax, fabs(start_value<T>(b0 + r, sl)));
  int chk = 0, jmax = 0;
  T top = 0;
  bool conv = false;
  for (int it = 0; it < kMaxIts; ++it) {
    const T xmax = solve(y, nb, n, f, tol, scl / bmax, it == 0 ? sl : -1,
                         b0, jmax, top);
    if (xmax >= dtpcrt) ++chk;
    bmax = xmax;
    if (chk >= kExtra + 1) {
      conv = true;
      break;
    }
  }
  if (!conv) s.misc()[0] = 1;
  constexpr int kChunk = 4;  // rows whose loads are issued together
  const T ymax = fabs(top);
  T ss = 0;
  for (int r0 = 0; r0 < nb; r0 += kChunk) {
    T q[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      q[c] = r0 + c < nb ? y[static_cast<size_t>(r0 + c) * n] / ymax : T(0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) ss += q[c] * q[c];
  }
  const T sc = copysign(T(1), top) / (ymax * sqrt(ss));
  for (int r0 = 0; r0 < nb; r0 += kChunk) {
    T q[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (r0 + c < nb) q[c] = y[static_cast<size_t>(r0 + c) * n];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (r0 + c < nb)
        V[static_cast<size_t>(b0 + r0 + c) * n + col] = q[c] * sc;
  }
}

// Phase B, one warp: the cluster of slots c0..c1 (one block), each
// vector after the first orthogonalised against those before it.
template <typename T>
__device__ void cluster_vectors(int c0, int c1, int n, T* V, Factors<T> f0,
                                const Shared<T> s) {
  const int lane = threadIdx.x & 31;
  const int b0 = s.first()[c0], b1 = s.last()[c0], nb = b1 - b0 + 1;
  const T onenrm = warp_max(block_norm(s, b0, b1, lane, 32));
  for (int jj = c0 + 1; jj <= c1; ++jj) {
    T* z = V + static_cast<size_t>(b0) * n + s.rank()[jj];
    T ref = 1;
    for (int attempt = 0;; ++attempt) {
      for (int pass = 0; pass < 2; ++pass) {
        for (int ii = c0; ii < jj; ++ii) {
          const T* q = V + static_cast<size_t>(b0) * n + s.rank()[ii];
          T dot = 0;
          for (int r = lane; r < nb; r += 32)
            dot += q[static_cast<size_t>(r) * n] * z[static_cast<size_t>(r) * n];
          dot = warp_sum(dot);
          for (int r = lane; r < nb; r += 32)
            z[static_cast<size_t>(r) * n] -= dot * q[static_cast<size_t>(r) * n];
          __syncwarp();
        }
      }
      T ss = 0, zmax = 0;
      for (int r = lane; r < nb; r += 32) {
        const T zr = z[static_cast<size_t>(r) * n];
        ss += zr * zr;
        zmax = fmax(zmax, fabs(zr));
      }
      const T nu = sqrt(warp_sum(ss)) / ref;
      zmax = warp_max(zmax);
      if (nu >= T(1.0 / 16)) break;
      if (attempt == kRetries) {
        if (lane == 0) s.misc()[0] = 1;
        break;
      }
      if (lane == 0) {
        const size_t base = static_cast<size_t>(b0) * n + jj;
        Factors<T> f{f0.u + base, f0.u1 + base, f0.u2 + base, f0.l + base,
                     f0.r + base, f0.piv + base};
        const T u_last = f.u[static_cast<size_t>(nb - 1) * n];
        T big = 0;
        for (int r = 0; r < nb; ++r) {
          const size_t at = static_cast<size_t>(r) * n;
          big = fmax(big, fmax(fabs(f.u[at]),
                               fmax(fabs(f.u1[at]), fabs(f.u2[at]))));
        }
        const T tol = big == T(0) ? Num<T>::eps : Num<T>::eps * big;
        const T scl = static_cast<T>(nb) * onenrm *
                      fmax(Num<T>::eps, fabs(u_last));
        int jmax;
        T top;
        solve(z, nb, n, f, tol, scl / (zmax == T(0) ? T(1) : zmax),
              zmax == T(0) ? jj : -1, b0, jmax, top);
      }
      __syncwarp();
      T rs = 0;
      for (int r = lane; r < nb; r += 32) {
        const T zr = z[static_cast<size_t>(r) * n];
        rs += zr * zr;
      }
      ref = sqrt(warp_sum(rs));
    }
    // Unit norm, the first largest entry positive.
    T best = -1, topv = 0;
    int bi = nb;
    for (int r = lane; r < nb; r += 32) {
      const T zr = z[static_cast<size_t>(r) * n];
      if (fabs(zr) > best) {
        best = fabs(zr);
        topv = zr;
        bi = r;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T ob = __shfl_xor_sync(kFull, best, o);
      const T ot = __shfl_xor_sync(kFull, topv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        topv = ot;
        bi = oi;
      }
    }
    T ss = 0;
    for (int r = lane; r < nb; r += 32) {
      const T q = z[static_cast<size_t>(r) * n] / best;
      ss += q * q;
    }
    const T sc = copysign(T(1), topv) / (best * sqrt(warp_sum(ss)));
    for (int r = lane; r < nb; r += 32) z[static_cast<size_t>(r) * n] *= sc;
    __syncwarp();
  }
}

// Phase C with V's columns in registers: C = 32 / G columns a warp, G
// lanes a column, TR rows a lane (rows g, g + G, ...); n <= G TR.
template <typename T, int G, int TR>
__device__ void back_transform_tile(const T* a, int ld, const T* tau, T* V,
                                    int n) {
  constexpr int C = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane / G, g = lane % G;
  for (int cg = warp; cg * C < n; cg += kWarps) {
    const int j = cg * C + c;
    T z[TR];
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int r = g + G * t;
      z[t] = j < n && r < n ? V[static_cast<size_t>(r) * n + j] : T(0);
    }
    for (int k = n - 3; k >= 0; --k) {
      const T tk = tau[k];
      if (tk == T(0)) continue;
      const T* v = a + static_cast<size_t>(k) * ld;  // v[r], r > k
      T dot[2] = {0, 0};  // two chains of FMAs
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (G * t + G - 1 <= k) continue;
        const int r = g + G * t;
        if (r > k && r < n) dot[t & 1] += v[r] * z[t];
      }
      T dk = dot[0] + dot[1];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        dk += __shfl_xor_sync(kFull, dk, o);
      const T fk = tk * dk;
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (G * t + G - 1 <= k) continue;
        const int r = g + G * t;
        if (r > k && r < n) z[t] -= fk * v[r];
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int r = g + G * t;
      if (j < n && r < n) V[static_cast<size_t>(r) * n + j] = z[t];
    }
  }
}

// Phase C past n = 512: a warp a column, from global memory.
template <typename T>
__device__ void back_transform_global(const T* a, int ld, const T* tau,
                                      T* V, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < n; j += kWarps) {
    T* z = V + j;
    for (int k = n - 3; k >= 0; --k) {
      const T tk = tau[k];
      if (tk == T(0)) continue;
      const T* v = a + static_cast<size_t>(k) * ld;
      T dot = 0;
      for (int r = lane; r < n; r += 32)
        if (r > k) dot += v[r] * z[static_cast<size_t>(r) * n];
      const T fk = tk * warp_sum(dot);
      for (int r = lane; r < n; r += 32)
        if (r > k) z[static_cast<size_t>(r) * n] -= fk * v[r];
    }
  }
}

template <typename T, bool kSharedA>
__global__ void __launch_bounds__(kThreads, 1)
eigh_kernel(const T* __restrict__ A, T* __restrict__ lam_out,
            T* __restrict__ V, int32_t* __restrict__ info, int n, T* ws) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const int ld = stride_of(n);
  const size_t na = static_cast<size_t>(n) * ld;
  // The workspace: the factors, the iterates, the pivots' bytes, then the
  // matrix where shared memory does not hold it (eigh_layout).
  Factors<T> f{ws, ws + nn, ws + 2 * nn, ws + 3 * nn, ws + 4 * nn,
               reinterpret_cast<unsigned char*>(ws + 6 * nn)};
  T* ys = ws + 5 * nn;
  T* sm = reinterpret_cast<T*>(raw);
  T* a = kSharedA ? sm : ws + 6 * nn + (nn + sizeof(T) - 1) / sizeof(T);
  const Shared<T> s{kSharedA ? sm + na : sm, n};

  // The lower triangle, rows ld apart.
  for (size_t q = tid; q < nn; q += kThreads) {
    const int i = static_cast<int>(q / n), j = static_cast<int>(q % n);
    if (j <= i) a[static_cast<size_t>(i) * ld + j] = A[q];
  }
  if (tid < 16) s.misc()[tid] = 0;
  __syncthreads();
  EIGH_STAMP(0);

  tridiagonalize(a, n, ld, s);
  __syncthreads();
  EIGH_STAMP(1);

  // xSTEBZ's splitting, the blocks' bounds and pivmin (cls holds the
  // split flags until the clusters are listed).
  T* pivmin = s.part();
  for (int i = tid; i < n; i += kThreads) {
    const T ulp = Num<T>::eps, ei = s.e()[i], e2 = ei * ei;
    const bool split =
        i == n - 1 ||
        fabs(s.d()[i] * s.d()[i + 1]) * (ulp * ulp) + Num<T>::tiny > e2;
    s.e()[i] = split ? T(0) : ei;
    s.e2()[i] = split ? T(0) : e2;
    s.cls()[i] = split;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    int j = i;
    while (!s.cls()[j]) ++j;
    s.last()[i] = j;
    j = i;
    while (j > 0 && !s.cls()[j - 1]) --j;
    s.first()[i] = j;
  }
  if (warp == 0) {
    T emax = 1;
    for (int i = tid; i < n; i += 32) emax = fmax(emax, s.e2()[i]);
    emax = warp_max(emax);
    if (tid == 0) *pivmin = Num<T>::tiny * emax;
  }
  __syncthreads();
  EIGH_STAMP(2);
  bisect(n, *pivmin, s);
  __syncthreads();
  EIGH_STAMP(3);

  // xSTEIN's shifts and the clusters of size two or more, a thread a
  // block (the list's order is the threads'; each cluster's vectors do
  // not depend on it); the ranks.
  for (int b0 = tid; b0 < n; b0 += kThreads) {
    if (s.first()[b0] != b0) continue;
    const int b1 = s.last()[b0];
    const T ortol = T(1e-3) * block_norm(s, b0, b1, 0, 1);
    int c0 = b0;
    s.xs()[b0] = s.lam()[b0];
    for (int sl = b0 + 1; sl <= b1 + 1; ++sl) {
      if (sl <= b1) {
        T x = s.lam()[sl];
        const T pertol = T(10) * fabs(Num<T>::eps * x);
        if (x - s.xs()[sl - 1] < pertol) x = s.xs()[sl - 1] + pertol;
        s.xs()[sl] = x;
        if (fabs(x - s.xs()[sl - 1]) <= ortol) continue;
      }
      if (sl - 1 > c0) {
        const int c = atomicAdd(s.misc() + 1, 1);
        s.cls()[c] = c0;
        s.cle()[c] = sl - 1;
      }
      c0 = sl;
    }
  }
  for (int sl = tid; sl < n; sl += kThreads) {
    const T x = s.lam()[sl];
    int r = 0;
    for (int t = 0; t < n; ++t) {
      const T y = s.lam()[t];
      r += y < x || (y == x && t < sl);
    }
    s.rank()[sl] = r;
    lam_out[r] = x;
  }
  for (size_t q = tid; q < nn; q += kThreads) V[q] = T(0);
  __syncthreads();
  EIGH_STAMP(4);

  for (int sl = tid; sl < n; sl += kThreads) slot_vector(sl, n, V, f, ys, s);
  __syncthreads();
  EIGH_STAMP(5);
  for (int c = warp; c < s.misc()[1]; c += kWarps)
    cluster_vectors(s.cls()[c], s.cle()[c], n, V, f, s);
  __syncthreads();
  EIGH_STAMP(6);

  if (n <= 64)
    back_transform_tile<T, 8, 8>(a, ld, s.tau(), V, n);
  else if (n <= 128)
    back_transform_tile<T, 8, 16>(a, ld, s.tau(), V, n);
  else if (n <= 256)
    back_transform_tile<T, 16, 16>(a, ld, s.tau(), V, n);
  else if (n <= 512)
    back_transform_tile<T, 32, 16>(a, ld, s.tau(), V, n);
  else
    back_transform_global(a, ld, s.tau(), V, n);
#ifdef EIGH_STAMPS
  __syncthreads();
  EIGH_STAMP(7);
#endif
  if (tid == 0) *info = s.misc()[0];
}

template <typename T, bool kSharedA>
int launch_as(const void* A, void* lam, void* V, int32_t* info, int n,
              size_t smem, void* ws, cudaStream_t st) {
  static size_t allowed = 0;  // the largest opt-in set so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        eigh_kernel<T, kSharedA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  eigh_kernel<T, kSharedA><<<1, kThreads, smem, st>>>(
      static_cast<const T*>(A), static_cast<T*>(lam), static_cast<T*>(V),
      info, n, static_cast<T*>(ws));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, void* lam, void* V, int32_t* info, int n,
           size_t smem, void* ws, int layout, cudaStream_t st) {
  return layout == 0
             ? launch_as<T, true>(A, lam, V, info, n, smem, ws, st)
             : launch_as<T, false>(A, lam, V, info, n, smem, ws, st);
}

}  // namespace

extern "C" int coarse_eigh_launch(const int64_t* args) {
  const void* A = reinterpret_cast<const void*>(args[0]);
  void* lam = reinterpret_cast<void*>(args[1]);
  void* V = reinterpret_cast<void*>(args[2]);
  auto* info = reinterpret_cast<int32_t*>(args[3]);
  const int n = static_cast<int>(args[4]);
  const int dtype = static_cast<int>(args[5]);
  const size_t smem = static_cast<size_t>(args[6]);  // kernels.py
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[7]);
  void* ws = reinterpret_cast<void*>(args[9]);
  const int layout = static_cast<int>(args[10]);
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(static_cast<int>(args[8]));
  if (err != cudaSuccess) return static_cast<int>(err);
#ifdef EIGH_STAMPS
  long long* stamps = reinterpret_cast<long long*>(args[11]);
  err = cudaMemcpyToSymbol(g_stamps, &stamps, sizeof stamps);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
  switch (dtype) {
    case 0:
      return launch<float>(A, lam, V, info, n, smem, ws, layout, st);
    case 1:
      return launch<double>(A, lam, V, info, n, smem, ws, layout, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* coarse_eigh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
