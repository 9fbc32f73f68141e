// Stencil kernels of the CPTR step: block matvec, scalar matvec, and the
// whole Chebyshev smooth.
//
// Replaces (thermalporous_tpu/kernels/stencil_pallas.py):
//   tp_block_matvec     <- block_matvec (207-314), and the column-restricted
//                          BlockStencil.matvec_cols (core/stencil.py:55-71),
//                          which has no Pallas twin;
//   tp_scalar_matvec    <- matvec (155-192);
//   tp_chebyshev_smooth <- chebyshev_smooth (317-405).
//
// What bounds them on the H100: bytes.  A 2D block matvec reads 45
// coefficients per cell for 3 multiply-adds per coefficient (about 0.4 flop
// per byte in f32), a scalar matvec 5 for 1, against a machine balance near
// 20 flop/byte at 3.35 TB/s.  So the design moves every coefficient once and
// nothing else:
//   - one thread per cell, consecutive threads on consecutive cells of the
//     last (contiguous) grid axis, so each coefficient channel streams fully
//     coalesced;
//   - the coefficients are read in the packed layout the assembly writes
//     ([diag, up_0, lo_0, up_1, lo_1, ...] x row-major nc x nc blocks), with
//     no repacking copy;
//   - neighbour values of v are re-read from L1/L2 (each v entry is read by
//     2*dim+1 threads that are close in time), so v costs about one pass;
//   - the column count k of the block matvec skips the (nc-k)/nc of the
//     coefficients that would multiply zeros (the CPTR stage-2 residual);
//   - the Chebyshev smooth is `degree` launches, each one pass over the
//     stencil that does the matvec, the D^-1 scaling and the three-term
//     recurrence update together (the x + d update is recomputed at the
//     neighbours instead of being written and read back).  The recurrence
//     scalars depend on lambda_max, which stays on the device: every thread
//     derives them from the device scalar, so there is no host sync.
//
// Each kernel reproduces the plain PyTorch version's order of operations
// (thermalporous_torch/kernels/stencil.py); compiled with --fmad=false it
// rounds the same way.

#include "common.cuh"

namespace tp {

// y = A v over block columns 0:k.  coef: ((2*dim+1)*NC*NC, n), v: (k, n),
// y: (NC, n).  Order per output row: diagonal block, then per axis the
// upper and the lower neighbour block, each a left-to-right sum over j.
template <typename T, int NC>
__global__ void block_matvec_kernel(const T* __restrict__ coef,
                                    const T* __restrict__ v,
                                    T* __restrict__ y, int k, Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  int idx[3];
  d.coords(c, idx);
  const long n = d.n;
  T out[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const T* w = coef + (long)(i * NC) * n + c;
    T acc = w[0] * v[c];
#pragma unroll
    for (int j = 1; j < NC; ++j)
      if (j < k) acc = acc + w[(long)j * n] * v[(long)j * n + c];
    out[i] = acc;
  }
  for (int a = 0; a < d.dim; ++a) {
    const long s = d.stride[a];
    if (idx[a] + 1 < d.ext[a]) {
      const T* blk = coef + (long)((1 + 2 * a) * NC * NC) * n + c;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const T* w = blk + (long)(i * NC) * n;
        T acc = w[0] * v[c + s];
#pragma unroll
        for (int j = 1; j < NC; ++j)
          if (j < k) acc = acc + w[(long)j * n] * v[(long)j * n + c + s];
        out[i] = out[i] + acc;
      }
    }
    if (idx[a] > 0) {
      const T* blk = coef + (long)((2 + 2 * a) * NC * NC) * n + c;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const T* w = blk + (long)(i * NC) * n;
        T acc = w[0] * v[c - s];
#pragma unroll
        for (int j = 1; j < NC; ++j)
          if (j < k) acc = acc + w[(long)j * n] * v[(long)j * n + c - s];
        out[i] = out[i] + acc;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) y[(long)i * n + c] = out[i];
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

template <typename T>
__global__ void scalar_matvec_kernel(const T* __restrict__ p,
                                     const T* __restrict__ v,
                                     T* __restrict__ y, Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  int idx[3];
  d.coords(c, idx);
  y[c] = apply_scalar(p, c, idx, d, [=](long i) { return v[i]; });
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

// First step: d0 = D^-1 (b - A x0) / theta (x0 == nullptr: d0 = D^-1 b /
// theta, no matvec).  With degree 1 it writes the result x0 + d0 instead.
template <typename T>
__global__ void cheb_first_kernel(const T* __restrict__ p, const T* __restrict__ b,
                                  const T* __restrict__ x, const T* __restrict__ lam,
                                  T frac, T safety, T* __restrict__ d_out,
                                  T* __restrict__ out, Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  T theta, c1, c2;
  cheb_scalars(*lam, frac, safety, 0, &theta, &c1, &c2);
  const T inv_diag = T(1) / p[c];
  T z;
  if (x == nullptr) {
    z = inv_diag * b[c];
  } else {
    int idx[3];
    d.coords(c, idx);
    z = inv_diag * (b[c] - apply_scalar(p, c, idx, d, [=](long i) { return x[i]; }));
  }
  const T d0 = z / theta;
  if (out != nullptr) {
    out[c] = (x == nullptr ? T(0) : x[c]) + d0;
  } else {
    d_out[c] = d0;
  }
}

// Step s >= 1: x_s = x_{s-1} + d_{s-1} (recomputed at the neighbours),
// z = D^-1 (b - A x_s), d_s = c1*d_{s-1} + c2*z.  The last step writes
// x_s + d_s to `out`; the others write x_s and d_s.
template <typename T>
__global__ void cheb_step_kernel(const T* __restrict__ p, const T* __restrict__ b,
                                 const T* __restrict__ x, const T* __restrict__ dd,
                                 const T* __restrict__ lam, T frac, T safety,
                                 int step, T* __restrict__ x_out,
                                 T* __restrict__ d_out, T* __restrict__ out,
                                 Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  T theta, c1, c2;
  cheb_scalars(*lam, frac, safety, step, &theta, &c1, &c2);
  int idx[3];
  d.coords(c, idx);
  auto xs = [=](long i) { return (x == nullptr ? T(0) : x[i]) + dd[i]; };
  const T inv_diag = T(1) / p[c];
  const T xc = xs(c);
  const T z = inv_diag * (b[c] - apply_scalar(p, c, idx, d, xs));
  const T dn = c1 * dd[c] + c2 * z;
  if (out != nullptr) {
    out[c] = xc + dn;
  } else {
    x_out[c] = xc;
    d_out[c] = dn;
  }
}

template <typename T>
int block_matvec(const void* coef, const void* v, void* y, int nc, int k,
                 Dims d, cudaStream_t st) {
  const T* c_ = static_cast<const T*>(coef);
  const T* v_ = static_cast<const T*>(v);
  T* y_ = static_cast<T*>(y);
  const unsigned g = blocks_for(d.n);
  switch (nc) {
    case 1: block_matvec_kernel<T, 1><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    case 2: block_matvec_kernel<T, 2><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    case 3: block_matvec_kernel<T, 3><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int chebyshev_smooth(const void* packed, const void* b, const void* x,
                     const void* lam, void* out, void* d_a, void* d_b,
                     void* x_a, void* x_b, int degree, double frac,
                     double safety, Dims d, cudaStream_t st) {
  const T* p = static_cast<const T*>(packed);
  const T* b_ = static_cast<const T*>(b);
  const T* l = static_cast<const T*>(lam);
  T* o = static_cast<T*>(out);
  T* dbuf[2] = {static_cast<T*>(d_a), static_cast<T*>(d_b)};
  T* xbuf[2] = {static_cast<T*>(x_a), static_cast<T*>(x_b)};
  const unsigned g = blocks_for(d.n);
  cheb_first_kernel<T><<<g, kThreads, 0, st>>>(
      p, b_, static_cast<const T*>(x), l, T(frac), T(safety), dbuf[0],
      degree == 1 ? o : nullptr, d);
  int err = (int)cudaGetLastError();
  const T* x_prev = static_cast<const T*>(x);
  for (int s = 1; s < degree && err == 0; ++s) {
    const bool last = s == degree - 1;
    T* x_next = last ? nullptr : xbuf[(s - 1) % 2];
    cheb_step_kernel<T><<<g, kThreads, 0, st>>>(
        p, b_, x_prev, dbuf[(s - 1) % 2], l, T(frac), T(safety), s, x_next,
        last ? nullptr : dbuf[s % 2], last ? o : nullptr, d);
    err = (int)cudaGetLastError();
    x_prev = x_next;
  }
  return err;
}

}  // namespace tp

extern "C" {

// dtype: 0 = float32, 1 = float64.
int tp_block_matvec(int dtype, const void* coef, const void* v, void* y,
                    int nc, int k, int dim, int n0, int n1, int n2,
                    void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? tp::block_matvec<float>(coef, v, y, nc, k, d, st)
                    : tp::block_matvec<double>(coef, v, y, nc, k, d, st);
}

int tp_scalar_matvec(int dtype, const void* packed, const void* v, void* y,
                     int dim, int n0, int n1, int n2, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = tp::blocks_for(d.n);
  if (dtype == 0)
    tp::scalar_matvec_kernel<float><<<g, tp::kThreads, 0, st>>>(
        static_cast<const float*>(packed), static_cast<const float*>(v),
        static_cast<float*>(y), d);
  else
    tp::scalar_matvec_kernel<double><<<g, tp::kThreads, 0, st>>>(
        static_cast<const double*>(packed), static_cast<const double*>(v),
        static_cast<double*>(y), d);
  return (int)cudaGetLastError();
}

int tp_chebyshev_smooth(int dtype, const void* packed, const void* b,
                        const void* x, const void* lam, void* out, void* d_a,
                        void* d_b, void* x_a, void* x_b, int degree,
                        double lam_min_frac, double safety, int dim, int n0,
                        int n1, int n2, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? tp::chebyshev_smooth<float>(packed, b, x, lam, out, d_a, d_b, x_a,
                                           x_b, degree, lam_min_frac, safety, d, st)
             : tp::chebyshev_smooth<double>(packed, b, x, lam, out, d_a, d_b, x_a,
                                            x_b, degree, lam_min_frac, safety, d, st);
}

}  // extern "C"
