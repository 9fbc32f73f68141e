// Shared helpers of the thermalporous_torch CUDA kernels: grid extents and
// strides of a C-contiguous 2D/3D cell array, the launch shape, and the
// storage type of preconditioner coefficients.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace tp {

using bf16 = __nv_bfloat16;

// Preconditioner coefficients are stored as C: the vectors' type T, or bf16
// (CPRConfig.pc_dtype).  A kernel converts each coefficient to T before any
// arithmetic, which is exact, so its sums keep the order and the rounding of
// the T form: the reference's bf16 array times an f32 or f64 array promotes
// the same way.
template <typename T, typename C>
struct Cvt {
  static __device__ __forceinline__ T f(C x) { return x; }
};
template <typename T>
struct Cvt<T, bf16> {
  static __device__ __forceinline__ T f(bf16 x) { return T(__bfloat162float(x)); }
};
template <typename T, typename C>
__device__ __forceinline__ T cv(C x) {
  return Cvt<T, C>::f(x);
}

// 1 / d of a diagonal coefficient d (already converted to T).  With bf16
// storage the reference's 1.0 / diag is a bf16 value (a Python scalar does
// not promote): the float quotient rounded to bf16, as torch and XLA form it.
template <typename T, typename C>
__device__ __forceinline__ T recip(T d) {
  if constexpr (std::is_same_v<C, bf16>)
    return T(__bfloat162float(__float2bfloat16_rn(1.0f / float(d))));
  else
    return T(1) / d;
}

// Dispatch on the entries' dtype code (kernels/_lib.py: dtype_code):
// 0 float, 1 double, 2 float with bf16 coefficients, 3 double with bf16.
#define TP_DISPATCH_TC(code, FN, ...)                         \
  ((code) == 0   ? FN<float, float>(__VA_ARGS__)              \
   : (code) == 1 ? FN<double, double>(__VA_ARGS__)            \
   : (code) == 2 ? FN<float, ::tp::bf16>(__VA_ARGS__)         \
   : (code) == 3 ? FN<double, ::tp::bf16>(__VA_ARGS__)        \
                 : (int)cudaErrorInvalidValue)

constexpr int kThreads = 256;

// Extents of the cell grid (ext[2] = 1 in 2D) and row-major strides.  A
// field with leading channels is laid out as channel * n + cell.
struct Dims {
  long n;
  int dim;
  int ext[3];
  long stride[3];

  // Grid coordinates of cell c.  Below 2^31 cells (a uniform test) the two
  // divisions are 32-bit, with each remainder taken from its quotient; a
  // 64-bit division costs the SM several times as many instructions.
  __device__ __forceinline__ void coords(long c, int idx[3]) const {
    if (n < (1L << 31)) {
      const unsigned cu = (unsigned)c, e2 = (unsigned)ext[2], e1 = (unsigned)ext[1];
      const unsigned r = cu / e2;
      idx[2] = (int)(cu - r * e2);
      const unsigned q = r / e1;
      idx[1] = (int)(r - q * e1);
      idx[0] = (int)q;
    } else {
      idx[2] = (int)(c % ext[2]);
      const long r = c / ext[2];
      idx[1] = (int)(r % ext[1]);
      idx[0] = (int)(r / ext[1]);
    }
  }
};

inline Dims make_dims(int dim, int n0, int n1, int n2) {
  Dims d;
  d.dim = dim;
  d.ext[0] = n0;
  d.ext[1] = n1;
  d.ext[2] = dim == 3 ? n2 : 1;
  d.stride[2] = 1;
  d.stride[1] = d.ext[2];
  d.stride[0] = (long)d.ext[1] * d.ext[2];
  d.n = (long)n0 * d.stride[0];
  return d;
}

inline unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Chebyshev scalars of step `step` (1-based; 0 gives only theta): the
// interval [frac*lam, safety*lam], theta/delta its centre and half-width,
// and the recurrence d <- c1*d + c2*z with rho_0 = delta/theta.
template <typename T>
__device__ __forceinline__ void cheb_scalars(T lam, T frac, T safety, int step,
                                             T* theta, T* c1, T* c2) {
  const T lmax = lam * safety;
  const T lmin = lam * frac;
  const T th = T(0.5) * (lmax + lmin);
  const T de = T(0.5) * (lmax - lmin);
  const T sigma1 = th / de;
  T rho = T(1) / sigma1;
  T a = T(0), b = T(0);
  for (int t = 0; t < step; ++t) {
    const T rn = T(1) / (T(2) * sigma1 - rho);
    a = rn * rho;
    b = T(2) * rn / de;
    rho = rn;
  }
  *theta = th;
  *c1 = a;
  *c2 = b;
}

}  // namespace tp
