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
//   - the block matvec takes one thread per cell, consecutive threads on
//     consecutive cells of the last (contiguous) grid axis, so each
//     coefficient channel streams fully coalesced;
//   - the coefficients are read in the packed layout the assembly writes
//     ([diag, up_0, lo_0, up_1, lo_1, ...] x row-major nc x nc blocks), with
//     no repacking copy;
//   - neighbour values of v are re-read from L1/L2 (each v entry is read by
//     2*dim+1 threads that are close in time), so v costs about one pass;
//   - the column count k of the block matvec skips the (nc-k)/nc of the
//     coefficients that would multiply zeros (the CPTR stage-2 residual);
//   - the scalar matvec takes a quad of 4 consecutive cells per thread:
//     16-byte loads and stores where the channels are aligned, 32-bit index
//     arithmetic (one division chain per quad, not per cell), every load
//     started before the first sum, and no barrier, so many blocks per SM
//     keep their loads in flight.  Most of its callers need not launch it
//     at all: the multigrid residual b - A x after a pre-smooth and the
//     K-cycle's product A e of a post-smooth's result are a second output
//     of the smooth's own launch (below), which has the stencil in shared
//     memory already;
//   - the Chebyshev smooth is ONE cooperative launch of at most one block
//     per SM.  As `degree` passes over the stencil it would move 12 values a
//     cell a step (48 at degree 4) where the function needs 10 in all, and
//     on the coarse levels each pass is launch-sized.  So a block owns a
//     contiguous range of cells for the whole smooth, a thread 4 consecutive
//     cells of it at a time (16-byte accesses where the channels are
//     aligned), and the block keeps the stencil channels, b and d of as many
//     of its cells as fit in its shared memory (all of them on every
//     flagship level but the finest, where three quarters fit in f32):
//     those come from device memory once per smooth.  A step writes
//     y = x + d, the next step's x, so only y crosses blocks, one vector
//     read at the neighbours, and cooperative_groups' grid.sync() separates
//     the steps (degree - 1 barriers of ~1.1 us).  A thread starts all loads
//     of its cells before it sums (neighbours from clamped addresses), so a
//     step costs one round trip to memory, not one per neighbour; that takes
//     ~128 registers, hence blocks of at most 512 threads.  The recurrence
//     scalars depend on lambda_max, which stays on the device: each block
//     tabulates them once from the device scalar, so there is no host sync.
//     What bounds it now: on the finest level the quarter of the cells whose
//     channels are re-read each step and the bytes that one block of
//     <= 512 threads per SM keeps in flight; on the coarse levels the launch
//     (~5 us) and the barriers.
//
// Coefficient storage (CPRConfig.pc_dtype): each kernel takes its stencil as
// C, the vectors' type T or bf16, and converts a coefficient to T as it is
// loaded (common.cuh: cv, recip), so the sums are the T form's.  With bf16
// a quad of one channel is one 8-byte load (load4), half the bytes of the
// f32 form's 16; the shared-memory cache of the smooth keeps the converted
// values.  Instantiated for (T, C) = (float, float), (double, double),
// (float, bf16) and (double, bf16).
//
// Batches (CPRConfig.batch_pt): the smooth takes up to kSmoothMaxBatch
// congruent members stacked along a leading axis of its stencil, vectors and
// lambda_max, numbered quad by quad one member after the other, in ONE
// launch with one member's barriers (a member's cells compute exactly what
// they compute alone: the smooth has no reduction).  The member count is a
// template parameter, so the unbatched kernel does no member arithmetic.
//
// Each kernel reproduces the plain PyTorch version's order of operations
// (thermalporous_torch/kernels/stencil.py); compiled with --fmad=false it
// rounds the same way.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tp {

// y = A v over block columns 0:k.  coef: ((2*dim+1)*NC*NC, n), v: (k, n),
// y: (NC, n).  Order per output row: diagonal block, then per axis the
// upper and the lower neighbour block, each a left-to-right sum over j.
template <typename T, typename C, int NC>
__global__ void block_matvec_kernel(const C* __restrict__ coef,
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
    const C* w = coef + (long)(i * NC) * n + c;
    T acc = cv<T>(w[0]) * v[c];
#pragma unroll
    for (int j = 1; j < NC; ++j)
      if (j < k) acc = acc + cv<T>(w[(long)j * n]) * v[(long)j * n + c];
    out[i] = acc;
  }
  for (int a = 0; a < d.dim; ++a) {
    const long s = d.stride[a];
    if (idx[a] + 1 < d.ext[a]) {
      const C* blk = coef + (long)((1 + 2 * a) * NC * NC) * n + c;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const C* w = blk + (long)(i * NC) * n;
        T acc = cv<T>(w[0]) * v[c + s];
#pragma unroll
        for (int j = 1; j < NC; ++j)
          if (j < k) acc = acc + cv<T>(w[(long)j * n]) * v[(long)j * n + c + s];
        out[i] = out[i] + acc;
      }
    }
    if (idx[a] > 0) {
      const C* blk = coef + (long)((2 + 2 * a) * NC * NC) * n + c;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const C* w = blk + (long)(i * NC) * n;
        T acc = cv<T>(w[0]) * v[c - s];
#pragma unroll
        for (int j = 1; j < NC; ++j)
          if (j < k) acc = acc + cv<T>(w[(long)j * n]) * v[(long)j * n + c - s];
        out[i] = out[i] + acc;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) y[(long)i * n + c] = out[i];
}

// Four consecutive cells of a channel: one 16-byte load in f32, two in f64.
// `vec` says that the channel's base and every quad offset are 16-byte
// aligned and every quad is whole (n % 4 == 0); otherwise the cells are
// loaded one by one and those at or beyond n read as zero.
template <typename T>
struct alignas(16) Pack16 {
  T v[16 / sizeof(T)];
};

// Four bf16 coefficients of a channel: one 8-byte load.
struct alignas(8) Bf16x4 {
  bf16 v[4];
};

// Values of type C (T, or bf16 coefficients), converted to T.
template <typename T, typename C>
__device__ __forceinline__ void load4(const C* p, bool vec, unsigned c0, unsigned n,
                                      T (&v)[4]) {
  if constexpr (std::is_same_v<C, bf16>) {
    if (vec) {
      const Bf16x4 t = *reinterpret_cast<const Bf16x4*>(p + c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = cv<T>(t.v[j]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = c0 + q < n ? cv<T>(p[c0 + q]) : T(0);
    }
  } else if (vec) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int h = 0; h < 4 / kPer; ++h) {
      const Pack16<T> t = *reinterpret_cast<const Pack16<T>*>(p + c0 + h * kPer);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[h * kPer + j] = t.v[j];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = c0 + q < n ? p[c0 + q] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, bool vec, unsigned c0, unsigned n,
                                       const T (&v)[4]) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int h = 0; h < 4 / kPer; ++h) {
      Pack16<T> t;
#pragma unroll
      for (int j = 0; j < kPer; ++j) t.v[j] = v[h * kPer + j];
      *reinterpret_cast<Pack16<T>*>(p + c0 + h * kPer) = t;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + q < n) p[c0 + q] = v[q];
  }
}

// A thread's four cells in the block's shared-memory cache: slot `s` of
// iteration `it`, laid out so that a warp's accesses are contiguous.
template <typename T>
struct alignas(16) Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ void get4(const Quad<T>& q, T (&w)[4]) {
  const Quad<T> t = q;
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = t.v[j];
}

template <typename T>
__device__ __forceinline__ void put4(Quad<T>& q, const T (&w)[4]) {
  Quad<T> t;
#pragma unroll
  for (int j = 0; j < 4; ++j) t.v[j] = w[j];
  q = t;
}

// The cell grid as the quad kernels see it: 32-bit throughout (n < 2^31).
struct QuadGrid {
  unsigned n;            // cells
  unsigned quads;        // groups of 4 consecutive cells, the last may be short
  int vec;               // 1: 16-byte loads and stores
  int ext[3];            // extents, slowest axis first (DIM of them)
  unsigned stride[3];
};

inline QuadGrid make_quad_grid(const Dims& d, int vec) {
  QuadGrid g;
  g.n = (unsigned)d.n;
  g.quads = (unsigned)((d.n + 3) / 4);
  g.vec = vec;
  for (int a = 0; a < 3; ++a) {
    g.ext[a] = a < d.dim ? d.ext[a] : 1;
    g.stride[a] = a < d.dim ? (unsigned)d.stride[a] : 0u;
  }
  return g;
}

// A v at the four cells c0..c0+3 of a scalar stencil whose channels `w` the
// caller has loaded: xc receives v at the cells, acc the products, summed in
// the plain version's order (diagonal, then per axis the upper and the lower
// neighbour; a neighbour beyond the boundary adds nothing).  Every load of v
// is started before the first sum: the neighbours come from clamped
// addresses (the cell's own where it has no neighbour, never used then), so
// no load waits on a branch.  With kFromQuad the neighbours along the last
// axis are taken from the quad's own values and only c0 - 1 and c0 + 4 are
// loaded: 6 loads fewer, which the standalone matvec gains from (0.0098
// against 0.0122 ms at 1024^2, 0.0165 against 0.0186 at 60x220x85, f32, H100)
// and the smooth does not (0.0474 against 0.0413 ms at 1024^2 and degree 4,
// equal in 3D), so the smooth loads them all.  `v` may have been written
// earlier in this launch by other blocks (behind a grid barrier), so it is
// read with plain loads.
template <typename T, int DIM, bool kFromQuad>
__device__ __forceinline__ void quad_matvec(T (&w)[2 * DIM + 1][4], const T* v,
                                            unsigned c0, const QuadGrid& g,
                                            T (&xc)[4], T (&acc)[4]) {
  const unsigned n = g.n;
  const bool vec = g.vec != 0;
  // which neighbours each of the four cells has
  int i[DIM];
  {
    unsigned r = c0;
#pragma unroll
    for (int a = DIM - 1; a > 0; --a) {
      const unsigned t = r / (unsigned)g.ext[a];
      i[a] = (int)(r - t * (unsigned)g.ext[a]);
      r = t;
    }
    i[0] = (int)r;
  }
  unsigned has = 0;   // bit 2*DIM*j + 2a: cell j has an upper neighbour on a; +1: lower
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c0 + j < n) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        if (i[a] + 1 < g.ext[a]) has |= 1u << (2 * DIM * j + 2 * a);
        if (i[a] > 0) has |= 1u << (2 * DIM * j + 2 * a + 1);
      }
    }
#pragma unroll
    for (int a = DIM - 1; a >= 0; --a) {     // advance to the next cell
      if (++i[a] < g.ext[a] || a == 0) break;
      i[a] = 0;
    }
  }
  load4(v, vec, c0, n, xc);
  T nb[2 * DIM][4];
#pragma unroll
  for (int a = 0; a < (kFromQuad ? DIM - 1 : DIM); ++a) {
    const unsigned st = g.stride[a];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned c = c0 + j < n ? c0 + j : c0;
      const unsigned bits = has >> (2 * DIM * j + 2 * a);
      nb[2 * a][j] = v[(bits & 1u) ? c + st : c];
      nb[2 * a + 1][j] = v[(bits & 2u) ? c - st : c];
    }
  }
  if constexpr (kFromQuad) {
    // the last axis (stride 1): inside the quad the neighbours are xc itself
    constexpr int a = DIM - 1;
    const unsigned up3 = (has >> (2 * DIM * 3 + 2 * a)) & 1u;
    const unsigned lo0 = (has >> (2 * a)) & 2u;
    const T above = v[up3 ? c0 + 4 : c0];
    const T below = v[lo0 ? c0 - 1 : c0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nb[2 * a][j] = j < 3 ? xc[j < 3 ? j + 1 : 3] : above;
      nb[2 * a + 1][j] = j > 0 ? xc[j > 0 ? j - 1 : 0] : below;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = w[0][j] * xc[j];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned bits = has >> (2 * DIM * j + 2 * a);
      if (bits & 1u) acc[j] = acc[j] + w[1 + 2 * a][j] * nb[2 * a][j];
      if (bits & 2u) acc[j] = acc[j] + w[2 + 2 * a][j] * nb[2 * a + 1][j];
    }
  }
}

// y = A v for a scalar stencil: a thread takes a quad (4 consecutive cells):
// 2*DIM+1 channel loads and one of v at 16 bytes each where `g.vec` allows
// (scalar loads otherwise), the 2*(DIM-1)*4 + 2 neighbour values of v from
// L1/L2 (along the last axis the quad's own values serve), one 16-byte store.  No barrier and no shared memory, so as many
// blocks are resident as the registers allow, and every SM has many loads in
// flight.
template <typename T, typename C, int DIM>
__global__ void __launch_bounds__(kThreads)
    scalar_matvec_kernel(const C* __restrict__ p, const T* __restrict__ v,
                         T* __restrict__ y, const __grid_constant__ QuadGrid g) {
  constexpr int NCH = 2 * DIM + 1;
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= g.quads) return;
  const unsigned c0 = 4 * q;
  T w[NCH][4];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) load4(p + (size_t)ch * g.n, g.vec != 0, c0, g.n, w[ch]);
  T xc[4], acc[4];
  quad_matvec<T, DIM, true>(w, v, c0, g, xc, acc);
  store4(y, g.vec != 0, c0, g.n, acc);
}

constexpr int kSmoothMaxThreads = 512;
constexpr int kSmoothTableSteps = 16;   // steps whose scalars are tabulated
constexpr int kSmoothMaxBatch = 2;      // members of one launch (batch_pt: p and T)
static_assert(kSmoothMaxBatch == 2, "cheb_smooth_kernel picks a quad's member by one compare");

struct SmoothPlan {
  QuadGrid g;            // one member's grid
  unsigned per_block;    // quads a block owns (a contiguous range over all members)
  unsigned cached_quads; // of which the first keep their channels in shared memory
  int iters;             // block-stride iterations over the block's range
  int second;            // 0: none; 1: also b - A y; 2: also A y (y the result)
  int batch;             // members, each g.quads quads, stacked one after the other
};

// The whole Chebyshev smooth in one cooperative launch.  Step 0:
// z = D^-1 (b - A x0) (x0 == nullptr: D^-1 b, no matvec), d = z / theta;
// step s >= 1: z = D^-1 (b - A y), d = c1*d + c2*z, with y the last step's
// x + d.  Every step writes y = x + d (the last one to `out`), so a step
// reads ONE vector at the neighbours, and only y crosses blocks: a grid
// barrier between steps.  d and, for the quads that fit, the stencil
// channels and b stay in the block's shared memory from step 0 on.
// A thread first starts every load of its quad (quad_matvec) and only then
// sums in the plain version's order, so the loads are in flight together
// instead of one round trip after another.
// With pl.second, one more pass behind one more barrier writes b - A y
// (1: the residual the V-cycle restricts) or A y (2: the K-cycle's product)
// of the final iterate to `out2`, with the channels and b of the cached
// quads still in shared memory: the scalar matvec that would follow the
// smooth, without its launch and without reading the stencil again.
// A batch (NM = 2 members; NM = 1 is the unbatched kernel, with no member
// arithmetic): quad q of the launch is quad q - m * g.quads of member m,
// whose stencil starts (2*DIM+1) * n coefficients and whose vectors n
// values after member m - 1's, and whose lambda_max is lam[m].
template <typename T, typename C, int DIM, int NM>
__global__ void __launch_bounds__(kSmoothMaxThreads, 1)
    cheb_smooth_kernel(const C* __restrict__ p, const T* __restrict__ b,
                       const T* __restrict__ x0, const T* __restrict__ lam, T frac,
                       T safety, int degree, T* ya, T* yb, T* dbuf, T* out, T* out2,
                       const __grid_constant__ SmoothPlan pl) {
  constexpr int NCH = 2 * DIM + 1;      // stencil channels
  // the cache: [slot][cached quad], slots 0..NCH-1 the channels, NCH b, NCH+1 d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Quad<T>* cache = reinterpret_cast<Quad<T>*>(smem_raw);
  __shared__ T coef_s[NM][kSmoothTableSteps][3];
  cg::grid_group grid = cg::this_grid();
  const unsigned n = pl.g.n;
  const unsigned mq = pl.g.quads;       // quads of one member
  const unsigned total = NM * mq;
  const unsigned ncq = pl.cached_quads;
  const bool vec = pl.g.vec != 0;
  T* ybuf[2] = {ya, yb};

  // the recurrence scalars of every member's steps, once per block (thread
  // t: member t / kSmoothTableSteps, step t % kSmoothTableSteps)
  {
    const int tm = (int)threadIdx.x / kSmoothTableSteps;
    const int ts = (int)threadIdx.x % kSmoothTableSteps;
    if (tm < NM && ts < degree)
      cheb_scalars(lam[tm], frac, safety, ts, &coef_s[tm][ts][0], &coef_s[tm][ts][1],
                   &coef_s[tm][ts][2]);
  }
  __syncthreads();

  // the first step that reads the off-diagonal channels
  const int first_off = x0 == nullptr ? 1 : 0;

  for (int s = 0; s < degree; ++s) {
    const T* src_all = s == 0 ? x0 : ybuf[(s - 1) & 1];
    T* dst_all = s == degree - 1 ? out : ybuf[s & 1];
    // this step's scalars of each member
    T theta_m[NM], c1_m[NM], c2_m[NM];
#pragma unroll
    for (int k = 0; k < NM; ++k) {
      if (s < kSmoothTableSteps) {
        theta_m[k] = coef_s[k][s][0], c1_m[k] = coef_s[k][s][1], c2_m[k] = coef_s[k][s][2];
      } else {
        cheb_scalars(lam[k], frac, safety, s, &theta_m[k], &c1_m[k], &c2_m[k]);
      }
    }
    for (int it = 0; it < pl.iters; ++it) {
      const unsigned lq = it * blockDim.x + threadIdx.x;
      const unsigned gq = blockIdx.x * pl.per_block + lq;
      if (lq >= pl.per_block || gq >= total) continue;
      const unsigned m = NM > 1 && gq >= mq ? 1u : 0u;     // NM <= 2
      const unsigned c0 = 4 * (gq - m * mq);
      const size_t vo = (size_t)m * n;                       // the member's vectors
      const C* pm = p + (size_t)m * NCH * n;                 // and stencil
      const T* bm = b + vo;
      const T* src = src_all == nullptr ? nullptr : src_all + vo;
      const T theta = theta_m[NM > 1 ? m : 0];
      const T c1 = c1_m[NM > 1 ? m : 0];
      const T c2 = c2_m[NM > 1 ? m : 0];
      const bool cached = lq < ncq;
      Quad<T>* slot = cache + lq;          // slot k of this quad: slot[k * ncq]

      // channels: diagonal and b from step 0 on, the off-diagonals from the
      // first step with a matvec; from device memory the first time (and
      // every time for quads beyond the cache), from the cache afterwards
      T w[NCH][4], bb[4], dd[4];
      if (cached && s > 0) {
        get4(slot[0], w[0]);
        get4(slot[NCH * ncq], bb);
        get4(slot[(NCH + 1) * ncq], dd);
      } else {
        load4(pm, vec, c0, n, w[0]);
        load4(bm, vec, c0, n, bb);
        if (s > 0) load4(dbuf + vo, vec, c0, n, dd);
        if (cached) {
          put4(slot[0], w[0]);
          put4(slot[NCH * ncq], bb);
        }
      }
      T xc[4], acc[4];
      if (src == nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) xc[j] = T(0);
      } else {
        if (cached && s > first_off) {
#pragma unroll
          for (int ch = 1; ch < NCH; ++ch) get4(slot[ch * ncq], w[ch]);
        } else {
#pragma unroll
          for (int ch = 1; ch < NCH; ++ch) load4(pm + (size_t)ch * n, vec, c0, n, w[ch]);
          if (cached) {
#pragma unroll
            for (int ch = 1; ch < NCH; ++ch) put4(slot[ch * ncq], w[ch]);
          }
        }
        quad_matvec<T, DIM, false>(w, src, c0, pl.g, xc, acc);
      }
      T y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T inv_diag = recip<T, C>(w[0][j]);
        const T z = src == nullptr ? inv_diag * bb[j] : inv_diag * (bb[j] - acc[j]);
        dd[j] = s == 0 ? z / theta : c1 * dd[j] + c2 * z;
        y[j] = xc[j] + dd[j];
      }
      if (s < degree - 1) {
        if (cached) {
          put4(slot[(NCH + 1) * ncq], dd);
        } else {
          store4(dbuf + vo, vec, c0, n, dd);
        }
      }
      store4(dst_all + vo, vec, c0, n, y);
    }
    if (s < degree - 1) grid.sync();
  }

  if (pl.second == 0) return;
  // the second output, from the final iterate in `out`: its neighbours were
  // written by other blocks, hence the barrier
  grid.sync();
  // a smooth with no matvec (one step from zero) has cached no off-diagonal
  const bool off_cached = degree > first_off;
  for (int it = 0; it < pl.iters; ++it) {
    const unsigned lq = it * blockDim.x + threadIdx.x;
    const unsigned gq = blockIdx.x * pl.per_block + lq;
    if (lq >= pl.per_block || gq >= total) continue;
    const unsigned m = NM > 1 && gq >= mq ? 1u : 0u;
    const unsigned c0 = 4 * (gq - m * mq);
    const size_t vo = (size_t)m * n;
    const C* pm = p + (size_t)m * NCH * n;
    const bool cached = lq < ncq;
    Quad<T>* slot = cache + lq;
    T w[NCH][4], bb[4];
    if (cached) {
      get4(slot[0], w[0]);
      get4(slot[NCH * ncq], bb);
    } else {
      load4(pm, vec, c0, n, w[0]);
      load4(b + vo, vec, c0, n, bb);
    }
    if (cached && off_cached) {
#pragma unroll
      for (int ch = 1; ch < NCH; ++ch) get4(slot[ch * ncq], w[ch]);
    } else {
#pragma unroll
      for (int ch = 1; ch < NCH; ++ch) load4(pm + (size_t)ch * n, vec, c0, n, w[ch]);
    }
    T yc[4], acc[4], r[4];
    quad_matvec<T, DIM, false>(w, out + vo, c0, pl.g, yc, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = pl.second == 1 ? bb[j] - acc[j] : acc[j];
    store4(out2 + vo, vec, c0, n, r);
  }
}

template <typename T, typename C>
int block_matvec(const void* coef, const void* v, void* y, int nc, int k,
                 Dims d, cudaStream_t st) {
  const C* c_ = static_cast<const C*>(coef);
  const T* v_ = static_cast<const T*>(v);
  T* y_ = static_cast<T*>(y);
  const unsigned g = blocks_for(d.n);
  switch (nc) {
    case 1: block_matvec_kernel<T, C, 1><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    case 2: block_matvec_kernel<T, C, 2><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    case 3: block_matvec_kernel<T, C, 3><<<g, kThreads, 0, st>>>(c_, v_, y_, k, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename C, int DIM>
int launch_smooth(const C* p, const T* b, const T* x, const T* lam, T frac, T safety,
                  int degree, T* ya, T* yb, T* dbuf, T* out, T* out2, SmoothPlan pl,
                  int blocks, int threads, size_t smem, cudaStream_t st) {
  const void* fn =
      pl.batch == 2 ? reinterpret_cast<const void*>(&cheb_smooth_kernel<T, C, DIM, 2>)
                    : reinterpret_cast<const void*>(&cheb_smooth_kernel<T, C, DIM, 1>);
  // more than 48 KB of dynamic shared memory must be opted in to, per
  // function and device: remember what was granted
  constexpr int kMaxDevices = 64;
  static size_t allowed[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  size_t& granted = allowed[pl.batch == 2][dev];
  if (smem > 48 * 1024 && smem > granted) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  void* args[] = {&p, &b, &x, &lam, &frac, &safety, &degree, &ya, &yb, &dbuf, &out, &out2,
                  &pl};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, smem, st);
}

template <typename T, typename C>
int chebyshev_smooth(const void* packed, const void* b, const void* x,
                     const void* lam, void* out, void* out2, void* y_a, void* y_b,
                     void* d_buf, int degree, double frac, double safety,
                     const SmoothPlan& pl, int dim, int blocks, int threads, size_t smem,
                     cudaStream_t st) {
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  auto m = [](void* q) { return static_cast<T*>(q); };
  const C* p = static_cast<const C*>(packed);
  return dim == 2
             ? launch_smooth<T, C, 2>(p, c(b), c(x), c(lam), T(frac), T(safety),
                                      degree, m(y_a), m(y_b), m(d_buf), m(out), m(out2), pl,
                                      blocks, threads, smem, st)
             : launch_smooth<T, C, 3>(p, c(b), c(x), c(lam), T(frac), T(safety),
                                      degree, m(y_a), m(y_b), m(d_buf), m(out), m(out2), pl,
                                      blocks, threads, smem, st);
}

template <typename T, typename C>
int scalar_matvec(const void* packed, const void* v, void* y, int dim, const QuadGrid& g,
                  int blocks, int threads, cudaStream_t st) {
  const C* p_ = static_cast<const C*>(packed);
  const T* v_ = static_cast<const T*>(v);
  T* y_ = static_cast<T*>(y);
  if (dim == 2)
    scalar_matvec_kernel<T, C, 2><<<blocks, threads, 0, st>>>(p_, v_, y_, g);
  else
    scalar_matvec_kernel<T, C, 3><<<blocks, threads, 0, st>>>(p_, v_, y_, g);
  return (int)cudaGetLastError();
}

}  // namespace tp

extern "C" {

// dtype: kernels/_lib.py: dtype_code (0 float, 1 double, 2 float with bf16
// coefficients, 3 double with bf16 coefficients).
int tp_block_matvec(int dtype, const void* coef, const void* v, void* y,
                    int nc, int k, int dim, int n0, int n1, int n2,
                    void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::block_matvec, coef, v, y, nc, k, d, st);
}

// `blocks` x `threads` threads, one quad (4 consecutive cells) each.  vec:
// 16-byte accesses (every pointer 16-byte aligned and n % 4 == 0).
int tp_scalar_matvec(int dtype, const void* packed, const void* v, void* y,
                     int dim, int n0, int n1, int n2, int blocks, int threads,
                     int vec, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  if ((dim != 2 && dim != 3) || d.n < 1 || d.n >= (1L << 31) || blocks < 1 ||
      threads < 32 || threads > tp::kThreads || threads % 32 != 0 ||
      (long)blocks * threads < (d.n + 3) / 4)
    return (int)cudaErrorInvalidValue;
  const tp::QuadGrid g = tp::make_quad_grid(d, vec);
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::scalar_matvec, packed, v, y, dim, g, blocks, threads, st);
}

// One cooperative launch of `blocks` x `threads`; a block owns `per_block`
// quads (4 consecutive cells) of the `batch` members' quads and walks them
// in `iters` block-stride iterations; its first `cached_quads` quads keep
// their channels in `smem` bytes of dynamic shared memory.  y_a, y_b, d_buf:
// batch * n values each (y_b and d_buf are untouched at degree <= 2 and 1).
// second: 0, or 1 to write b - A out, or 2 to write A out, to out2
// (batch * n values; else unused).  vec: 16-byte accesses (every pointer
// 16-byte aligned and n % 4 == 0).  A grid that cannot be co-resident is
// refused with an error.
int tp_chebyshev_smooth(int dtype, const void* packed, const void* b,
                        const void* x, const void* lam, void* out, void* out2,
                        void* y_a, void* y_b, void* d_buf, int degree,
                        double lam_min_frac, double safety, int dim, int n0,
                        int n1, int n2, int blocks, int threads, int per_block,
                        int iters, int cached_quads, int smem, int vec, int second,
                        int batch, void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  if ((dim != 2 && dim != 3) || d.n < 1 || batch < 1 || batch > tp::kSmoothMaxBatch ||
      batch * d.n >= (1L << 31) || degree < 1 || blocks < 1 ||
      threads < 32 || threads > tp::kSmoothMaxThreads || threads % 32 != 0 ||
      per_block < 1 ||
      iters < 1 || cached_quads < 0 || cached_quads > per_block || smem < 0 ||
      (long)iters * threads < per_block || second < 0 || second > 2 ||
      (second != 0 && out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  tp::SmoothPlan pl;
  pl.g = tp::make_quad_grid(d, vec);
  pl.per_block = (unsigned)per_block;
  pl.iters = iters;
  pl.cached_quads = (unsigned)cached_quads;
  pl.second = second;
  pl.batch = batch;
  const long quad_bytes = 4L * (dtype % 2 == 0 ? 4 : 8);
  if ((long)blocks * per_block < (long)batch * pl.g.quads ||
      (long)cached_quads * (2 * dim + 3) * quad_bytes > smem ||
      (cached_quads < per_block && cached_quads % 32 != 0))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::chebyshev_smooth, packed, b, x, lam, out, out2, y_a,
                        y_b, d_buf, degree, lam_min_frac, safety, pl, dim, blocks,
                        threads, (size_t)smem, st);
}

}  // extern "C"
