// The C entries of the red-black stage 2 and half-sweep (rbgs.cuh), and
// their instantiations with coefficients of the vectors' type; the bf16
// ones are in rbgs_bf16.cu.

#include "rbgs.cuh"

namespace tp {

extern template int stage2_typed<float, bf16>(int, const void*, const void*, const void*,
                                              const void*, void*, int, int,
                                              const Stage2Plan&, int, int, cudaStream_t);
extern template int stage2_typed<double, bf16>(int, const void*, const void*, const void*,
                                               const void*, void*, int, int,
                                               const Stage2Plan&, int, int, cudaStream_t);
extern template int half_typed<float, bf16>(const void*, const void*, const void*,
                                            const void*, void*, int, int, int, const Dims&,
                                            cudaStream_t);
extern template int half_typed<double, bf16>(const void*, const void*, const void*,
                                             const void*, void*, int, int, int, const Dims&,
                                             cudaStream_t);

}  // namespace tp


extern "C" {

// dtype: kernels/_lib.py: dtype_code.  x1 holds k columns (unread when k = 0).
// ty, tz, lx: the in-plane tile (tz even; ty = 1 in 2D) and the planes per
// block; the tile's pair and ring threads together at most
// kStage2MaxThreads.  par: the colour offset, the index sum of the grid's
// origin in a larger grid mod 2 (a block of a decomposed grid keeps the
// whole grid's colouring).
int tp_stage2_rbgs(int dtype, const void* coef, const void* dinv, const void* r,
                   const void* x1, void* out, int nc, int k, int dim, int n0, int n1,
                   int n2, int ty, int tz, int lx, int par, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  if ((dim != 2 && dim != 3) || d.n < 1 || d.n >= (1L << 31) || ty < 1 || tz < 2 ||
      (tz & 1) || lx < 1 || (dim == 2 && ty != 1) || k < 0 || k > nc || (par != 0 && par != 1))
    return (int)cudaErrorInvalidValue;
  tp::Stage2Plan p;
  p.n = (unsigned)d.n;
  p.e0 = n0;
  p.e1 = dim == 3 ? n1 : 1;
  p.e2 = dim == 3 ? n2 : n1;
  p.ty = ty;
  p.tz = tz;
  p.lx = lx;
  p.tiles_y = (p.e1 + ty - 1) / ty;
  p.tiles_z = (p.e2 + tz - 1) / tz;
  p.own = 32 * ((ty * (tz / 2) + 31) / 32);
  p.par = par;
  const int threads = p.own + 32 * ((tp::stage2_ring(dim, ty, tz) + 31) / 32);
  if (threads > tp::kStage2MaxThreads) return (int)cudaErrorInvalidValue;
  const long blocks = (long)p.tiles_y * p.tiles_z * ((p.e0 + lx - 1) / lx);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::stage2_typed, dim, coef, dinv, r, x1, out, nc, k, p,
                        (int)blocks, threads, st);
}

// colour: 0 = red (index sum plus par even), 1 = black; par as for
// tp_stage2_rbgs.
int tp_block_rbgs_half(int dtype, const void* coef, const void* dinv, const void* b,
                       const void* x, void* out, int colour, int par, int nc, int dim,
                       int n0, int n1, int n2, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  if ((dim != 2 && dim != 3) || (colour != 0 && colour != 1) || (par != 0 && par != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::half_typed, coef, dinv, b, x, out, colour, par, nc, d,
                        st);
}

}  // extern "C"
