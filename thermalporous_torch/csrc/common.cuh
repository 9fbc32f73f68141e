// Shared helpers of the thermalporous_torch CUDA kernels: grid extents and
// strides of a C-contiguous 2D/3D cell array, and the launch shape.
#pragma once

#include <cuda_runtime.h>

namespace tp {

constexpr int kThreads = 256;

// Extents of the cell grid (ext[2] = 1 in 2D) and row-major strides.  A
// field with leading channels is laid out as channel * n + cell.
struct Dims {
  long n;
  int dim;
  int ext[3];
  long stride[3];

  __device__ __forceinline__ void coords(long c, int idx[3]) const {
    idx[2] = (int)(c % ext[2]);
    long r = c / ext[2];
    idx[1] = (int)(r % ext[1]);
    idx[0] = (int)(r / ext[1]);
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

// Scalar stencil applied at cell c to the field given by `val(index)`.
// packed: (2*dim+1, n) = [diag, up_0, lo_0, ...].
template <typename T, typename Val>
__device__ __forceinline__ T apply_scalar(const T* __restrict__ p, long c,
                                          const int idx[3], const Dims& d,
                                          Val val) {
  const long n = d.n;
  T acc = p[c] * val(c);
  for (int a = 0; a < d.dim; ++a) {
    const long s = d.stride[a];
    if (idx[a] + 1 < d.ext[a]) acc = acc + p[(1 + 2 * a) * n + c] * val(c + s);
    if (idx[a] > 0) acc = acc + p[(2 + 2 * a) * n + c] * val(c - s);
  }
  return acc;
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
