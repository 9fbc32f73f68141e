// One zero-start red-black block Gauss-Seidel sweep in one launch: the CPTR
// stage 2 of the flagship preset (stage2="rbgs", stage2_sweeps=1).
//
// Replaces thermalporous_tpu/kernels/stencil_pallas.py:fused_block_rbgs
// (408-624).  Math (zero start, one sweep, red = even index sum):
//   x_r = red (.) D^-1 b;   out = x_r + black (.) D^-1 (b - A x_r)
// A red cell writes D^-1 b.  A black cell's neighbours are all red, so
// A x_r there needs only the off-diagonal blocks times D^-1 b recomputed
// at the six (four in 2D) neighbours from dinv and b; its own x_r is zero.
//
// What bounds it on the H100: bytes.  Per cell it must read the 63
// coefficient fields (45 in 2D) of a black cell, the 9 dinv and 3 b fields,
// and write 3: about 78 x 4 B per cell in f32, 0.35 GB at 60x220x85, for
// 3 multiply-adds per coefficient.  The design:
//   - one thread per cell on the port's packed (2*dim+1, nc, nc, *grid)
//     layout, consecutive threads on consecutive cells of the contiguous
//     last axis; no padding or re-layout (the Pallas kernel's z-to-128 and
//     x-to-8 padded lane layout was a Mosaic constraint);
//   - red threads read no stencil coefficients at all, so the coefficient
//     array is read once, half of it, where the two-pass form reads it
//     twice;
//   - dinv and b at the neighbours are re-read through L1/L2 (each is read
//     by 2*dim+1 nearby threads), so they cost about one pass.
//
// The order of operations is the plain version's
// (thermalporous_torch/kernels/stencil.py:block_rbgs_zero_plain): each
// neighbour block's row sum left to right, axes in order, up before low;
// built with --fmad=false it rounds the same way.

#include "common.cuh"

namespace tp {

// out_i = sum_j w[i, j] v_j at cell c, w: (NC, NC, n) block field
template <typename T, int NC>
__device__ __forceinline__ void block_apply(const T* __restrict__ w,
                                            const T v[NC], long c, long n,
                                            T out[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    T acc = w[(long)(i * NC) * n + c] * v[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = acc + w[(long)(i * NC + j) * n + c] * v[j];
    out[i] = acc;
  }
}

template <typename T, int NC>
__device__ __forceinline__ void red_value(const T* __restrict__ dinv,
                                          const T* __restrict__ b, long c,
                                          long n, T out[NC]) {
  T bc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) bc[j] = b[(long)j * n + c];
  block_apply<T, NC>(dinv, bc, c, n, out);
}

template <typename T, int NC>
__global__ void rbgs_zero_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ dinv,
                                 const T* __restrict__ b, T* __restrict__ out,
                                 Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  int idx[3];
  d.coords(c, idx);
  const long n = d.n;
  if (((idx[0] + idx[1] + idx[2]) & 1) == 0) {  // red
    T xr[NC];
    red_value<T, NC>(dinv, b, c, n, xr);
#pragma unroll
    for (int i = 0; i < NC; ++i) out[(long)i * n + c] = xr[i];
    return;
  }
  // black: y = A x_r, where x_r is zero here and D^-1 b at the neighbours
  T y[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) y[i] = T(0);
  for (int a = 0; a < d.dim; ++a) {
    const long s = d.stride[a];
    for (int side = 0; side < 2; ++side) {
      const bool up = side == 0;
      if (up ? idx[a] + 1 >= d.ext[a] : idx[a] == 0) continue;
      const long nb = up ? c + s : c - s;
      T xr[NC], part[NC];
      red_value<T, NC>(dinv, b, nb, n, xr);
      block_apply<T, NC>(coef + (long)((1 + 2 * a + side) * NC * NC) * n, xr,
                         c, n, part);
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = y[i] + part[i];
    }
  }
  T r[NC], x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) r[i] = b[(long)i * n + c] - y[i];
  block_apply<T, NC>(dinv, r, c, n, x);
#pragma unroll
  for (int i = 0; i < NC; ++i) out[(long)i * n + c] = x[i];
}

template <typename T>
int rbgs_zero(const void* coef, const void* dinv, const void* b, void* out,
              int nc, Dims d, cudaStream_t st) {
  const T* c_ = static_cast<const T*>(coef);
  const T* d_ = static_cast<const T*>(dinv);
  const T* b_ = static_cast<const T*>(b);
  T* o_ = static_cast<T*>(out);
  const unsigned g = blocks_for(d.n);
  switch (nc) {
    case 1: rbgs_zero_kernel<T, 1><<<g, kThreads, 0, st>>>(c_, d_, b_, o_, d); break;
    case 2: rbgs_zero_kernel<T, 2><<<g, kThreads, 0, st>>>(c_, d_, b_, o_, d); break;
    case 3: rbgs_zero_kernel<T, 3><<<g, kThreads, 0, st>>>(c_, d_, b_, o_, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace tp

extern "C" {

// dtype: 0 = float32, 1 = float64.
int tp_block_rbgs_zero(int dtype, const void* coef, const void* dinv,
                       const void* b, void* out, int nc, int dim, int n0,
                       int n1, int n2, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? tp::rbgs_zero<float>(coef, dinv, b, out, nc, d, st)
                    : tp::rbgs_zero<double>(coef, dinv, b, out, nc, d, st);
}

}  // extern "C"
