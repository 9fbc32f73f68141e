// The CPTR stage 2 with red-black block Gauss-Seidel in one launch, and a
// general red-black half-sweep.
//
// Replaces thermalporous_tpu/kernels/stencil_pallas.py:fused_block_rbgs
// (408-624), together with the stage-2 residual before it and the add after
// it (thermalporous_tpu/precond/cpr.py:659-693):
//   tp_stage2_rbgs     x1 = [x1_cols; 0] (k columns; k = 0: x1 = 0),
//                      r2 = r - A[:, 0:k] x1,   x_r = red (.) D^-1 r2,
//                      out = x1 + x_r + black (.) D^-1 (r2 - A x_r);
//                      k = 0 is the zero-start sweep fused_block_rbgs;
//   tp_block_rbgs_half x <- x + colour (.) D^-1 (b - A x) for one colour:
//                      the looped form's half-sweep (stage2_sweeps > 1, a
//                      nonzero start).  Red = even index sum.
//
// What bounds the stage 2 on the H100: bytes.  The function needs every
// cell's coefficient columns 0:k (42 planes at nc = 3, k = 2), the black
// cells' other off-diagonal columns, D^-1, r, x1 and out: about 68 values a
// cell, 0.3 GB in f32 at 60x220x85, for ~2 operations a value.  Before, the
// stage ran as four dispatches (block_matvec at k = 2, a subtraction, the
// sweep, an add) that streamed the column-0:k planes twice.  Design:
//   - a block owns a tile of the plane of the last two axes (ty rows of tz
//     cells, tz even) and marches through lx planes along axis 0
//     (kernels/stencil.py: stage2_plan), as the residual kernel does;
//   - a pair thread owns two consecutive cells of a row: in every plane
//     one of the two is red and one black, and the pair's black cell of
//     plane x lies under its red cell of plane x + 1.  So at each step it
//     computes x_r = D^-1 r2 of its red cell of plane x + 1 (r2 from the
//     columns 0:k of all 2*dim+1 blocks and x1 at the neighbours), then its
//     black cell of plane x, whose neighbours are all red: along axis 0
//     from its own registers (this step's value, and the one from two steps
//     back), in the plane from a shared-memory buffer of the previous step;
//   - ring threads (whole warps after the pair threads) compute the red
//     values of the tile's one-cell ring into that buffer, one cell each;
//     their coefficient sectors are the neighbouring tile's, read at about
//     the same time, so L2 serves them;
//   - a black cell reads each of its coefficients once and uses it twice:
//     columns 0:k against x1 for r2 and every column against x_r, with two
//     accumulators.  The red cells of plane x + 1 and the black cells of
//     plane x touch the same column-0:k sectors one step apart;
//   - every value a step needs is computed at a cell clamped into the grid
//     and into the tile, with neighbour addresses clamped to the cell
//     itself, so a thread's loads of a step (~160 for a pair thread in f32)
//     are unconditional and issued together, before the first sum: one
//     round trip to memory a step.  That takes ~130 registers in f32, so a
//     block of up to 384 threads runs alone on its SM, and the plan cuts
//     axis 0 into chunks for one wave of blocks;
//   - two shared-memory buffers of x_r alternate between the planes: one
//     block barrier a step; no grid barrier, no scratch in device memory;
//   - 32-bit cell indices (n < 2^31), 64-bit plane offsets.
// What holds it back (PERF.md): the barrier of each step drains the one
// block's loads, the ring's red values are computed twice, and a chunk's
// boundary planes are read again.
// The half-sweep is simple: one thread per cell, the cells of the other
// colour copy x.
//
// The order of operations is the plain versions'
// (thermalporous_torch/kernels/stencil.py: fused_stage2_rbgs_plain,
// block_rbgs_half_sweep_plain): each block's row sum left to right, the
// blocks in block_matvec_plain's order (diagonal, then up before low along
// each axis), r2 = r - A x1, D^-1 (r2 - A x_r), then + x1.  Built with
// --fmad=false it rounds the same way.
//
// The stencil and D^-1 are read as C, the vectors' type T or bf16
// (CPRConfig.pc_dtype: both cast together), each value converted to T as
// it is loaded (common.cuh: cv), so the sums are the T form's.  This header
// holds the templates; rbgs.cu instantiates C = T and the C entries,
// rbgs_bf16.cu C = bf16, so that the two compile in parallel.

#pragma once

#include "common.cuh"

namespace tp {

// Most threads of a block: the tile's pair threads and its ring threads.
constexpr int kStage2MaxThreads = 384;

// The tiling of stage2_kernel (kernels/stencil.py: stage2_plan).  The grid
// is seen as (e0, e1, e2) with e1 = 1 in 2D: a block marches along axis 0
// through lx planes of a tile of ty rows of tz cells (tz even).  Threads
// [0, own) take the tile's pairs (tz / 2 a row; own rounded up to whole
// warps); the threads after them take one red cell each of the tile's
// one-cell ring.
struct Stage2Plan {
  unsigned n;
  int e0, e1, e2;
  int ty, tz, lx;
  int tiles_y, tiles_z;
  int own;
  int par;  // the colour offset: a cell is red when its index sum plus par is even
};

// The 2*DIM+1 blocks of a cell in the packed order [diag, up_0, lo_0, up_1,
// lo_1, ...]: whether each neighbour exists and its cell, or the cell
// itself where it does not (so that every load is valid).
template <int DIM>
struct Nbrs {
  bool has[2 * DIM + 1];
  unsigned nb[2 * DIM + 1];
};

template <int DIM>
__device__ __forceinline__ Nbrs<DIM> neighbours(const Stage2Plan& p, unsigned c, int x,
                                                int y, int z) {
  const unsigned s0 = (unsigned)p.e1 * (unsigned)p.e2, s1 = (unsigned)p.e2;
  Nbrs<DIM> q;
  q.has[0] = true;
  q.nb[0] = c;
  q.has[1] = x + 1 < p.e0;
  q.has[2] = x > 0;
  q.nb[1] = q.has[1] ? c + s0 : c;
  q.nb[2] = q.has[2] ? c - s0 : c;
  if constexpr (DIM == 3) {
    q.has[3] = y + 1 < p.e1;
    q.has[4] = y > 0;
    q.nb[3] = q.has[3] ? c + s1 : c;
    q.nb[4] = q.has[4] ? c - s1 : c;
  }
  constexpr int oz = 2 * DIM - 1;              // up along the contiguous axis
  q.has[oz] = z + 1 < p.e2;
  q.has[oz + 1] = z > 0;
  q.nb[oz] = q.has[oz] ? c + 1 : c;
  q.nb[oz + 1] = q.has[oz + 1] ? c - 1 : c;
  return q;
}

// out = D^-1 v at cell c, row i: sum_j dinv[i, j] v_j left to right
template <typename T, typename C, int NC>
__device__ __forceinline__ void apply_dinv(const C* __restrict__ dinv, unsigned c,
                                           unsigned n, const T v[NC], T out[NC]) {
  T w[NC * NC];
#pragma unroll
  for (int e = 0; e < NC * NC; ++e) w[e] = cv<T>(dinv[(size_t)e * n + c]);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    T acc = w[i * NC] * v[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = acc + w[i * NC + j] * v[j];
    out[i] = acc;
  }
}

// x_r = D^-1 r2 at red cell c, r2 = r - A[:, 0:K] x1
template <typename T, typename C, int NC, int K, int DIM>
__device__ __forceinline__ void red_value(const C* __restrict__ coef,
                                          const C* __restrict__ dinv,
                                          const T* __restrict__ r,
                                          const T* __restrict__ x1, unsigned c,
                                          unsigned n, const Nbrs<DIM>& q, T xr[NC]) {
  T r2[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) r2[i] = r[(size_t)i * n + c];
  if constexpr (K > 0) {
    T acc[NC];
#pragma unroll
    for (int o = 0; o < 2 * DIM + 1; ++o) {
      T v[K], w[NC * K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = x1[(size_t)j * n + q.nb[o]];
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          w[i * K + j] = cv<T>(coef[(size_t)((o * NC + i) * NC + j) * n + c]);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        T part = w[i * K] * v[0];
#pragma unroll
        for (int j = 1; j < K; ++j) part = part + w[i * K + j] * v[j];
        if (o == 0)
          acc[i] = part;
        else if (q.has[o])
          acc[i] = acc[i] + part;
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) r2[i] = r2[i] - acc[i];
  }
  apply_dinv<T, C, NC>(dinv, c, n, r2, xr);
}

// The black cell c: r2 = r - A[:, 0:K] x1 and D^-1 (r2 - A x_r), whose
// x_r is zero at c and xn[o] at neighbour o; each off-diagonal coefficient
// is read once and serves both sums.
template <typename T, typename C, int NC, int K, int DIM>
__device__ __forceinline__ void black_value(const C* __restrict__ coef,
                                            const C* __restrict__ dinv,
                                            const T* __restrict__ r,
                                            const T* __restrict__ x1, unsigned c,
                                            unsigned n, const Nbrs<DIM>& q,
                                            const T xn[2 * DIM + 1][NC], T out[NC]) {
  T acc_r[NC], acc_y[NC];
  if constexpr (K > 0) {
    T v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = x1[(size_t)j * n + c];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      T part = cv<T>(coef[(size_t)(i * NC) * n + c]) * v[0];
#pragma unroll
      for (int j = 1; j < K; ++j) part = part + cv<T>(coef[(size_t)(i * NC + j) * n + c]) * v[j];
      acc_r[i] = part;
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) acc_y[i] = T(0);
#pragma unroll
  for (int o = 1; o < 2 * DIM + 1; ++o) {
    T w[NC * NC];
#pragma unroll
    for (int e = 0; e < NC * NC; ++e) w[e] = cv<T>(coef[(size_t)(o * NC * NC + e) * n + c]);
    if constexpr (K > 0) {
      T v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = x1[(size_t)j * n + q.nb[o]];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        T part = w[i * NC] * v[0];
#pragma unroll
        for (int j = 1; j < K; ++j) part = part + w[i * NC + j] * v[j];
        if (q.has[o]) acc_r[i] = acc_r[i] + part;
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      T part = w[i * NC] * xn[o][0];
#pragma unroll
      for (int j = 1; j < NC; ++j) part = part + w[i * NC + j] * xn[o][j];
      if (q.has[o]) acc_y[i] = acc_y[i] + part;
    }
  }
  T t[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    T r2 = r[(size_t)i * n + c];
    if constexpr (K > 0) r2 = r2 - acc_r[i];
    t[i] = r2 - acc_y[i];
  }
  apply_dinv<T, C, NC>(dinv, c, n, t, out);
}

template <typename T, int NC, int K>
__device__ __forceinline__ void write_out(T* __restrict__ out, const T* __restrict__ x1,
                                          unsigned c, unsigned n, const T v[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i)
    out[(size_t)i * n + c] = i < K ? v[i] + x1[(size_t)i * n + c] : v[i];
}

// coef: ((2*DIM+1)*NC*NC, n), dinv: (NC*NC, n), r, out: (NC, n), x1: (K, n).
// Every value a step needs is computed at a cell clamped into the grid, so
// that each thread's loads of a step are unconditional and can all be in
// flight at once; only the stores depend on whether the cell exists.
template <typename T, typename C, int NC, int K, int DIM>
__global__ void __launch_bounds__(kStage2MaxThreads, 1)
    stage2_kernel(const C* __restrict__ coef, const C* __restrict__ dinv,
                  const T* __restrict__ r, const T* __restrict__ x1, T* __restrict__ out,
                  Stage2Plan p) {
  constexpr int PY = DIM == 3 ? 1 : 0;         // ring rows below and above the tile
  constexpr int NB = 2 * DIM + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);     // [2][NC][hp]: x_r of two planes
  const unsigned n = p.n;
  const int hz = p.tz + 2;                     // row length of the tile with its ring
  const int hp = (p.ty + 2 * PY) * hz;
  const int pz = p.tz >> 1;

  const int tid = (int)threadIdx.x;
  int blk = (int)blockIdx.x;
  const int bz = blk % p.tiles_z;
  blk /= p.tiles_z;
  const int by = blk % p.tiles_y;
  const int bx = blk / p.tiles_y;
  const int y0 = by * p.ty, z0 = bz * p.tz;
  const int x_begin = bx * p.lx;
  const int x_end = min(x_begin + p.lx, p.e0);

  // a pair thread: cells (za, za + 1) of row y; in each plane one is red
  // and one black, and its black cell of plane x lies under its red cell
  // of plane x + 1
  const bool own = tid < p.own;
  const int ly = tid / pz;
  const int y = y0 + ly, za = z0 + 2 * (tid - ly * pz);
  const bool mine = own && ly < p.ty && y < p.e1;
  // a ring thread: the j-th red cell of ring segment s (before and after
  // the rows, then the rows below and above the tile)
  const int k = tid - p.own;
  const int hy = (p.ty + 1) >> 1, hr = PY ? pz : 0;
  const int s = k < hy ? 0 : k < 2 * hy ? 1 : k < 2 * hy + hr ? 2 : 3;
  const int j = k - (s == 0 ? 0 : s == 1 ? hy : s == 2 ? 2 * hy : 2 * hy + hr);
  const bool ringt = !own && k < 2 * hy + 2 * hr;
  const int ys = s == 2 ? y0 - 1 : s == 3 ? y0 + p.ty : y0;
  const int zs = s == 0 ? z0 - 1 : s == 1 ? z0 + p.tz : z0;
  const int len = s < 2 ? p.ty : p.tz;

  auto cell = [&](int x, int yy, int z) {
    return ((unsigned)x * (unsigned)p.e1 + (unsigned)yy) * (unsigned)p.e2 + (unsigned)z;
  };
  auto slot = [&](int yy, int z) { return (yy - y0 + PY) * hz + (z - z0 + 1); };
  // this thread's red cell of plane x (clamped into the grid) and whether
  // it exists
  auto red_cell = [&](int x, int& yy, int& zz) {
    bool ok;
    if (own) {
      yy = y;
      zz = za + ((x + y + p.par) & 1);
      ok = mine && zz < p.e2;
    } else {
      const int i = ((x + ys + zs + p.par) & 1) + 2 * j;
      yy = s < 2 ? ys + i : ys;
      zz = s < 2 ? zs : zs + i;
      ok = ringt && i < len && yy >= 0 && yy < p.e1 && zz >= 0 && zz < p.e2;
    }
    yy = min(max(yy, 0), p.e1 - 1);
    zz = min(max(zz, 0), p.e2 - 1);
    return ok && x < p.e0;
  };
  auto red_at = [&](int x, int yy, int zz, T xr[NC]) {
    const int xc = min(x, p.e0 - 1);
    const unsigned c = cell(xc, yy, zz);
    red_value<T, C, NC, K, DIM>(coef, dinv, r, x1, c, n, neighbours<DIM>(p, c, xc, yy, zz),
                                xr);
  };
  auto publish = [&](int b, int yy, int z, const T xr[NC]) {
    T* B = buf + b * NC * hp;
    const int sl = slot(yy, z);
#pragma unroll
    for (int i = 0; i < NC; ++i) B[i * hp + sl] = xr[i];
  };

  // x_r of this thread's column: `lo` at plane x - 1 under this step's
  // black cell, `hold` at plane x (next step's `lo`), `up` at plane x + 1
  T lo[NC], hold[NC], up[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) lo[i] = hold[i] = up[i] = T(0);
  {
    int yy, zz;
    const bool ok = red_cell(x_begin, yy, zz);
    red_at(x_begin, yy, zz, hold);
    if (ok) {
      publish(0, yy, zz, hold);
      if (own) write_out<T, NC, K>(out, x1, cell(x_begin, yy, zz), n, hold);
    }
    if (own && x_begin > 0)
      red_at(x_begin - 1, min(y, p.e1 - 1), min(za + ((x_begin + y + p.par + 1) & 1), p.e2 - 1), lo);
  }
  __syncthreads();

  for (int x = x_begin; x < x_end; ++x) {
    const int cur = (x - x_begin) & 1;
    int ry, rz;
    const bool red_ok = red_cell(x + 1, ry, rz);
    if (own) {
      // the red cell of plane x + 1 above this thread's black cell of
      // plane x, then the black cell: one round of loads for both
      red_at(x + 1, ry, rz, up);
      const int zb = za + ((x + y + p.par + 1) & 1);
      const bool black_ok = mine && zb < p.e2;
      // clamped into the grid and the tile: the slots read below stay in the buffer
      const int yc = min(y, min(y0 + p.ty, p.e1) - 1), zc = min(zb, p.e2 - 1);
      const unsigned c = cell(x, yc, zc);
      const T* B = buf + cur * NC * hp;
      const int sl = slot(yc, zc);
      T xn[NB][NC], v[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        xn[0][i] = T(0);
        xn[1][i] = up[i];
        xn[2][i] = lo[i];
        if constexpr (DIM == 3) {
          xn[3][i] = B[i * hp + sl + hz];
          xn[4][i] = B[i * hp + sl - hz];
        }
        xn[2 * DIM - 1][i] = B[i * hp + sl + 1];
        xn[2 * DIM][i] = B[i * hp + sl - 1];
      }
      black_value<T, C, NC, K, DIM>(coef, dinv, r, x1, c, n,
                                    neighbours<DIM>(p, c, x, yc, zc), xn, v);
      if (red_ok) {
        publish(cur ^ 1, ry, rz, up);
        if (x + 1 < x_end) write_out<T, NC, K>(out, x1, cell(x + 1, ry, rz), n, up);
      }
      if (black_ok) write_out<T, NC, K>(out, x1, c, n, v);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        lo[i] = hold[i];
        hold[i] = up[i];
      }
    } else {
      red_at(x + 1, ry, rz, up);
      if (red_ok) publish(cur ^ 1, ry, rz, up);
    }
    __syncthreads();
  }
}

// The ring threads of a tile: the red cells of its ring in one plane, at
// most, and the block's threads (kernels/stencil.py: Stage2Plan).
inline int stage2_ring(int dim, int ty, int tz) {
  return 2 * ((ty + 1) / 2) + (dim == 3 ? 2 * (tz / 2) : 0);
}

// Bytes of dynamic shared memory of one block: two planes' x_r of the tile
// with its ring (kernels/stencil.py: Stage2Plan.smem).
inline size_t stage2_smem(int dim, int ty, int tz, int nc, size_t item) {
  return 2 * (size_t)nc * (ty + (dim == 3 ? 2 : 0)) * (tz + 2) * item;
}

template <typename T, typename C, int NC, int K>
int launch_stage2(int dim, const void* coef, const void* dinv, const void* r,
                  const void* x1, void* out, const Stage2Plan& p, int blocks, int threads,
                  size_t smem, cudaStream_t st) {
  auto c_ = static_cast<const C*>(coef);
  auto d_ = static_cast<const C*>(dinv);
  auto r_ = static_cast<const T*>(r);
  auto x_ = static_cast<const T*>(x1);
  auto o_ = static_cast<T*>(out);
  if (dim == 3)
    stage2_kernel<T, C, NC, K, 3><<<blocks, threads, smem, st>>>(c_, d_, r_, x_, o_, p);
  else
    stage2_kernel<T, C, NC, K, 2><<<blocks, threads, smem, st>>>(c_, d_, r_, x_, o_, p);
  return (int)cudaGetLastError();
}

// bf16 coefficients are instantiated for the CPTR state's two and three
// unknowns only (a CPR stencil has at least two).
template <typename T, typename C>
int stage2_typed(int dim, const void* coef, const void* dinv, const void* r, const void* x1,
                 void* out, int nc, int k, const Stage2Plan& p, int blocks, int threads,
                 cudaStream_t st) {
  const size_t smem = stage2_smem(dim, p.ty, p.tz, nc, sizeof(T));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
#define TP_STAGE2(NC_, K_)                                                                  \
  case NC_ * 4 + K_:                                                                        \
    if constexpr (NC_ == 1 && std::is_same_v<C, bf16>)                                      \
      return (int)cudaErrorInvalidValue;                                                    \
    else                                                                                    \
      return launch_stage2<T, C, NC_, K_>(dim, coef, dinv, r, x1, out, p, blocks, threads,  \
                                          smem, st)
  switch (nc * 4 + k) {
    TP_STAGE2(1, 0);
    TP_STAGE2(1, 1);
    TP_STAGE2(2, 0);
    TP_STAGE2(2, 1);
    TP_STAGE2(2, 2);
    TP_STAGE2(3, 0);
    TP_STAGE2(3, 1);
    TP_STAGE2(3, 2);
    TP_STAGE2(3, 3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_STAGE2
}

// One half-sweep: cells of `colour` (0 red, 1 black) get
// x + D^-1 (b - A x), A over all blocks in block_matvec_plain's order; the
// others copy x.
template <typename T, typename C, int NC>
__global__ void __launch_bounds__(kThreads)
    rbgs_half_kernel(const C* __restrict__ coef, const C* __restrict__ dinv,
                     const T* __restrict__ b, const T* __restrict__ x, T* __restrict__ out,
                     int colour, int par, Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  int idx[3];
  d.coords(c, idx);
  const long n = d.n;
  if (((idx[0] + idx[1] + idx[2] + par) & 1) != colour) {
#pragma unroll
    for (int i = 0; i < NC; ++i) out[(long)i * n + c] = x[(long)i * n + c];
    return;
  }
  auto block_row_sums = [&](int o, long m, T part[NC]) {
    const C* w = coef + (long)(o * NC * NC) * n + c;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      T acc = cv<T>(w[(long)(i * NC) * n]) * x[m];
#pragma unroll
      for (int j = 1; j < NC; ++j)
        acc = acc + cv<T>(w[(long)(i * NC + j) * n]) * x[(long)j * n + m];
      part[i] = acc;
    }
  };
  T y[NC], part[NC];
  block_row_sums(0, c, y);
  for (int a = 0; a < d.dim; ++a) {
    const long s = d.stride[a];
    if (idx[a] + 1 < d.ext[a]) {
      block_row_sums(1 + 2 * a, c + s, part);
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = y[i] + part[i];
    }
    if (idx[a] > 0) {
      block_row_sums(2 + 2 * a, c - s, part);
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = y[i] + part[i];
    }
  }
  T t[NC], dx[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) t[i] = b[(long)i * n + c] - y[i];
  apply_dinv<T, C, NC>(dinv, (unsigned)c, (unsigned)n, t, dx);
#pragma unroll
  for (int i = 0; i < NC; ++i) out[(long)i * n + c] = x[(long)i * n + c] + dx[i];
}

template <typename T, typename C>
int half_typed(const void* coef, const void* dinv, const void* b, const void* x, void* out,
               int colour, int par, int nc, const Dims& d, cudaStream_t st) {
  auto c_ = static_cast<const C*>(coef);
  auto d_ = static_cast<const C*>(dinv);
  auto b_ = static_cast<const T*>(b);
  auto x_ = static_cast<const T*>(x);
  auto o_ = static_cast<T*>(out);
  const unsigned g = blocks_for(d.n);
  switch (nc) {
    case 1:
      if constexpr (std::is_same_v<C, bf16>) return (int)cudaErrorInvalidValue;
      else rbgs_half_kernel<T, C, 1><<<g, kThreads, 0, st>>>(c_, d_, b_, x_, o_, colour, par, d);
      break;
    case 2: rbgs_half_kernel<T, C, 2><<<g, kThreads, 0, st>>>(c_, d_, b_, x_, o_, colour, par, d); break;
    case 3: rbgs_half_kernel<T, C, 3><<<g, kThreads, 0, st>>>(c_, d_, b_, x_, o_, colour, par, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace tp
