// The whole multigrid coarse-grid correction below a level in one launch:
// V-, W- or K-cycle recursion, Chebyshev smoothing, constant-transfer
// restriction and prolongation, and the dense coarsest-level solve.
//
// Replaces thermalporous_tpu/kernels/deep_cycle.py:deep_correction (289-365,
// math in _correction_math 209-272, the W-cycle at 250-252).
//
// What bounds it on the H100: latency, not bytes.  The subtree it walks is
// small (the flagship's pressure hierarchy below 145k cells is ~10 MB of
// coefficients and vectors in f32, L2-resident), but the recursion is a
// chain of dependent passes over small grids: its least time is the number
// of passes times what one pass and the barrier after it cost, whatever
// the bytes.  So the design shortens the chain and widens each link:
//   - ONE cooperative launch of up to one block per SM; a pass is a
//     grid-stride loop (about one cell a thread on the entry level, the
//     first few blocks only on the coarser ones) followed by a grid-wide
//     barrier (cooperative_groups' grid.sync()), so nothing goes back to the
//     host and every pass has the whole card;
//   - a cell belongs to the same thread in every pass over its level, so a
//     pass that reads only the cell's own values needs no barrier before it
//     and is run together with its neighbour in the chain (the K-cycle's
//     vector updates with the first smoothing step after them);
//   - a Chebyshev step writes y = x + d, which is the next step's x, so each
//     step is one pass with one barrier and reads one vector at the
//     neighbours; y alternates between two buffers, d is read and written
//     by its owner only;
//   - the K-cycle's matvec and its dot products are one pass: every block
//     leaves its partial sums in scratch and, after the barrier, every block
//     adds all blocks' partials in the same fixed order, so all blocks get
//     the same bits, take the same branches, and two runs agree bitwise (no
//     floating-point atomics anywhere);
//   - a pass starts all loads of a cell before it sums (the neighbours from
//     clamped addresses, used or not), so it costs one round trip to the L2
//     and not one per neighbour;
//   - the W-cycle's residual b - A e1 is one pass with the first step of
//     the second cycle's pre-smooth (both read the cell's own values after
//     e1's barrier), and its sum e1 + e2 is written by the last step of the
//     second cycle's post-smooth: W adds no barrier to its two cycles;
//   - the dense coarsest solve is one warp per row of the inverse over all
//     blocks' warps;
//   - the recursion is an explicit loop over a per-level stage counter, and
//     the Chebyshev scalars of every level and step are computed once per
//     block into shared memory.
// What remains is the chain itself: the barriers of one visit (counted by
// the kernel on request) times a barrier's latency (~1.1 us) plus one
// round trip to the L2 a pass.
//
// Every pass follows the plain version's order of operations
// (thermalporous_torch/kernels/deep_cycle.py:deep_correction_plain), so
// with --fmad=false only the dot products and the dense solve (summation
// order) round differently.
//
// The level stencils are read as C, the vectors' type T or bf16
// (CPRConfig.pc_dtype), each coefficient converted to T as it is loaded
// (common.cuh: cv, recip); lambda_max and the coarsest inverse stay T.
//
// A batch (CPRConfig.batch_pt: the p and T hierarchies, congruent, stacked)
// is one launch: every pass walks each member's cells in turn with the
// grid-stride mapping one member alone would get (the launch shape is one
// member's), so a member's dot products see the same partial sums in the
// same order and the member's result has the bits of its own launch, while
// the barriers are those of one visit.  A member's stencil lies
// (2*dim+1) * n coefficients after the previous one's, its vectors n values
// after, its lambda_max one value and its coarsest inverse m * m values
// after; its K-cycle scalars are its own.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tp {

constexpr int kDeepMaxThreads = 1024;
constexpr int kMaxLevels = 16;
constexpr int kMaxDegree = 16;
constexpr int kDescPerLevel = 20;
constexpr int kMaxDots = 3;
constexpr int kDeepMaxBatch = 2;

// a level's cycle kind (kernels/deep_cycle.py: SINGLE, KCYCLE, WCYCLE)
enum Kind { kSingle = 0, kK = 1, kW = 2 };

// kYa/kYb: the two buffers a smooth alternates between; the one that does
// not hold the pre-smoothed x also takes the residual.
enum Vec { kB, kOut, kE1, kV1, kR1, kE2, kV2, kYa, kYb, kD, kNumVec };

struct DeepLevel {
  const void* packed;  // (batch, 2*dim+1, n) scalar stencils, of the coefficient type
  const void* lam;     // (batch,) lambda_max on the device (unused on the coarsest)
  void* vec[kNumVec];
  Dims d;
  int fac[3];          // coarsening factors to the next level
  int kind;            // Kind: single cycle, K-cycle or W-cycle
};

struct DeepParams {
  const void* inv;     // (batch, m, m) dense inverses of the coarsest operator
  void* partials;      // kMaxDots * batch * gridDim.x partial dot products
  int* barriers;       // nullable: receives the number of grid barriers
  double frac;
  double safety;
  int degree;
  int n_levels;
  int batch;           // members, 1 <= batch <= kDeepMaxBatch
  DeepLevel lev[kMaxLevels];
};

template <typename T>
struct ChebCoef {
  T theta, c1, c2;
};

// What a thread needs in every pass: the grid, its place in it, the
// barrier count, and the block's tables in shared memory.
template <typename T, int NM>
struct Ctx {
  cg::grid_group grid;
  unsigned gtid, gsize;
  int nbar;
  const ChebCoef<T>* coef;   // [(member * levels + level) * degree + step]
  T* red;                    // NM * kMaxDots * 32 values for block reductions

  __device__ __forceinline__ void sync() {
    grid.sync();
    ++nbar;
  }
};

// Each member m < NM (the batch, a template parameter: NM = 1 is the
// unbatched kernel) of a level of n cells in turn, with the grid-stride
// mapping of an unbatched launch; vectors of the level are offset by m * n.
#define TP_FOR_MEMBER_CELLS(n)                                   \
  for (int m = 0; m < NM; ++m)                                    \
    for (unsigned c = cx.gtid; c < (unsigned)(n); c += cx.gsize)

template <typename T>
__device__ __forceinline__ T* vp(const DeepLevel& L, int k) {
  return static_cast<T*>(L.vec[k]);
}

// member m's stencil of level L
template <typename C>
__device__ __forceinline__ const C* pk(const DeepLevel& L, int m) {
  return static_cast<const C*>(L.packed) + (size_t)m * (2 * L.d.dim + 1) * (size_t)L.d.n;
}

__device__ __forceinline__ void coords32(const Dims& d, unsigned c, int idx[3]) {
  const unsigned e2 = d.ext[2], e1 = d.ext[1];
  const unsigned r = c / e2;
  idx[2] = (int)(c - r * e2);
  const unsigned q = r / e1;
  idx[1] = (int)(r - q * e1);
  idx[0] = (int)q;
}

// The scalar stencil at cell c applied to v, with every load started before
// the sum: a neighbour is read from a clamped address (the cell's own where
// there is none; the value is then not used), so no load waits on a branch
// and a pass costs one round trip to the L2 instead of one per neighbour.
// The sum is in apply_scalar's order.
template <typename T, typename C>
__device__ __forceinline__ T apply_batched(const C* __restrict__ p, unsigned c,
                                           const int idx[3], const Dims& d,
                                           const T* v) {
  const size_t n = (size_t)d.n;
  bool up[3], lo[3];
  T wu[3], wl[3], vu[3], vl[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const unsigned s = (unsigned)d.stride[a];
    const bool on = a < d.dim;
    up[a] = on && idx[a] + 1 < d.ext[a];
    lo[a] = on && idx[a] > 0;
    wu[a] = cv<T>(p[(on ? 1 + 2 * a : 0) * n + c]);
    wl[a] = cv<T>(p[(on ? 2 + 2 * a : 0) * n + c]);
    vu[a] = v[up[a] ? c + s : c];
    vl[a] = v[lo[a] ? c - s : c];
  }
  T acc = cv<T>(p[c]) * v[c];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (up[a]) acc = acc + wu[a] * vu[a];
    if (lo[a]) acc = acc + wl[a] * vl[a];
  }
  return acc;
}

// One Chebyshev step on the thread's cells of level L (no barrier).
// Step 0: z = D^-1 (b - A x), x = src (nullptr: zero, and no matvec);
// d = z / theta.  Step s >= 1: x = src = the last step's y;
// d = c1 * d + c2 * z.  Both write d and y = x + d to dst, or add + y
// when `add` is given (the W-cycle's e1 + e2).
template <typename T, typename C, int NM>
__device__ void dk_cheb_step(Ctx<T, NM>& cx, int ell, int levels, int degree,
                             const DeepLevel& L, int s, const T* b, const T* src, T* dst,
                             const T* add = nullptr) {
  const Dims& d = L.d;
  const size_t n = (size_t)d.n;
  TP_FOR_MEMBER_CELLS(d.n) {
    const C* p = pk<C>(L, m);
    const ChebCoef<T>& k = cx.coef[(m * levels + ell) * degree + s];
    T* dd = vp<T>(L, kD) + m * n;
    const size_t mc = m * n + c;
    const T inv_diag = recip<T, C>(cv<T>(p[c]));
    T xc = T(0), z;
    if (src == nullptr) {
      z = inv_diag * b[mc];
    } else {
      int idx[3];
      coords32(d, c, idx);
      xc = src[mc];
      z = inv_diag * (b[mc] - apply_batched(p, c, idx, d, src + m * n));
    }
    const T dn = s == 0 ? z / k.theta : k.c1 * dd[c] + k.c2 * z;
    dd[c] = dn;
    const T y = xc + dn;
    dst[mc] = add == nullptr ? y : add[mc] + y;
  }
}

// The smooth of b from x = ybuf[cur] (zero start: cur < 0) on level L;
// steps first..degree-1 (the caller may have run step 0 itself), a barrier
// after each.  The last step writes `out` when it is given (add + y when
// `add` is given too).  Returns the index of the buffer that holds the
// result (unchanged when `out` took it).
template <typename T, typename C, int NM>
__device__ int dk_smooth(Ctx<T, NM>& cx, const DeepParams& P, int ell, const T* b,
                         int cur, int first, T* out, const T* add = nullptr) {
  const DeepLevel& L = P.lev[ell];
  T* y[2] = {vp<T>(L, kYa), vp<T>(L, kYb)};
  for (int s = first; s < P.degree; ++s) {
    const T* src = cur < 0 ? nullptr : y[cur];
    const int nxt = cur < 0 ? 0 : 1 - cur;
    const bool last = s == P.degree - 1 && out != nullptr;
    dk_cheb_step<T, C, NM>(cx, ell, P.n_levels - 1, P.degree, L, s, b, src,
                       last ? out : y[nxt], last ? add : nullptr);
    if (!last) cur = nxt;
    cx.sync();
  }
  return cur;
}

// y = A v on the thread's cells, and the thread's share of K dot products
// <a_k, e_k> (a_k == nullptr: the fresh y) into acc, per member
template <typename T, typename C, int NM, int K>
__device__ void dk_matvec_dots(Ctx<T, NM>& cx, const DeepLevel& L, const T* v, T* y,
                               const T* const (&a)[K], const T* const (&e)[K],
                               T (&acc)[NM][K]) {
  const Dims& d = L.d;
  const size_t n = (size_t)d.n;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[m][k] = T(0);
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const C* p = pk<C>(L, m);
    for (unsigned c = cx.gtid; c < (unsigned)d.n; c += cx.gsize) {
      int idx[3];
      coords32(d, c, idx);
      const size_t mc = m * n + c;
      const T yc = apply_batched(p, c, idx, d, v + m * n);
      y[mc] = yc;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[m][k] = acc[m][k] + (a[k] == nullptr ? yc : a[k][mc]) * e[k][mc];
    }
  }
}

// The K sums over all threads of the grid, the same bits in every thread:
// warp shuffles, the block's warps in order, the block's partial to
// scratch, a grid barrier, then every block adds all partials in one order.
// Each member's k-th sum as the unbatched kernel forms it: slot i = m * K + k
// of the tables holds member m's sum k.
template <typename T, int NM, int K>
__device__ void dk_reduce(Ctx<T, NM>& cx, const DeepParams& P, T (&acc)[NM][K]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const unsigned nb = gridDim.x;
  T* part = static_cast<T*>(P.partials);
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = m * K + k;
      for (int off = 16; off > 0; off >>= 1)
        acc[m][k] += __shfl_down_sync(0xffffffffu, acc[m][k], off);
      if (lane == 0) cx.red[i * 32 + warp] = acc[m][k];
    }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NM * K; ++i) {
      T v = lane < nw ? cx.red[i * 32 + lane] : T(0);
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) part[i * nb + blockIdx.x] = v;
    }
  }
  cx.sync();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NM * K; ++i) {
      T v = T(0);
      for (unsigned j = lane; j < nb; j += 32) v = v + part[i * nb + j];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) cx.red[i * 32] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[m][k] = cx.red[(m * K + k) * 32];
  __syncthreads();
}

// Summation restriction of r (fine level F) into rc (coarse level C): the
// pair sums of axis 0 first, then axis 1, then axis 2, out-of-range cells
// zero (the plain version's padded block sums, in its order).
template <typename T, int NM>
__device__ void dk_restrict(Ctx<T, NM>& cx, const DeepLevel& F, const DeepLevel& C,
                            const T* r, T* rc) {
  const Dims& f = F.d;
  const int* fac = F.fac;
  TP_FOR_MEMBER_CELLS(C.d.n) {
    const T* rm = r + (size_t)m * f.n;
    int I[3];
    coords32(C.d, c, I);
    T s2[2] = {T(0), T(0)};
    for (int k2 = 0; k2 < fac[2]; ++k2) {
      const int i2 = fac[2] == 2 ? 2 * I[2] + k2 : I[2];
      T s1[2] = {T(0), T(0)};
      for (int k1 = 0; k1 < fac[1]; ++k1) {
        const int i1 = fac[1] == 2 ? 2 * I[1] + k1 : I[1];
        T s0[2] = {T(0), T(0)};
        for (int k0 = 0; k0 < fac[0]; ++k0) {
          const int i0 = fac[0] == 2 ? 2 * I[0] + k0 : I[0];
          if (i0 < f.ext[0] && i1 < f.ext[1] && i2 < f.ext[2])
            s0[k0] = rm[i0 * f.stride[0] + i1 * f.stride[1] + i2];
        }
        s1[k1] = fac[0] == 2 ? s0[0] + s0[1] : s0[0];
      }
      s2[k2] = fac[1] == 2 ? s1[0] + s1[1] : s1[0];
    }
    rc[(size_t)m * C.d.n + c] = fac[2] == 2 ? s2[0] + s2[1] : s2[0];
  }
}

// x += P ec: piecewise-constant prolongation from C back to F
template <typename T, int NM>
__device__ void dk_prolong_add(Ctx<T, NM>& cx, const DeepLevel& F, const DeepLevel& C,
                               const T* ec, T* x) {
  const Dims& f = F.d;
  const int* fac = F.fac;
  TP_FOR_MEMBER_CELLS(f.n) {
    int i[3];
    coords32(f, c, i);
    long cc = 0;
    for (int a = 0; a < 3; ++a) cc += (long)(fac[a] == 2 ? i[a] / 2 : i[a]) * C.d.stride[a];
    const size_t mc = (size_t)m * f.n + c;
    x[mc] = x[mc] + ec[(size_t)m * C.d.n + cc];
  }
}

// out = inv b on the coarsest level: one warp per row, all blocks' warps;
// each member's rows in turn
template <typename T, int NM>
__device__ void dk_dense(Ctx<T, NM>& cx, const T* inv, const T* b, T* out, unsigned n) {
  const int lane = threadIdx.x & 31;
  const unsigned nw = cx.gsize >> 5;
  for (int m = 0; m < NM; ++m) {
    const T* im = inv + (size_t)m * n * n;
    const T* bm = b + (size_t)m * n;
    for (unsigned i = cx.gtid >> 5; i < n; i += nw) {
      T acc = T(0);
      for (unsigned j = lane; j < n; j += 32) acc = acc + im[(size_t)i * n + j] * bm[j];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) out[(size_t)m * n + i] = acc;
    }
  }
}

// First half of a cycle on level ell, after step 0 of the pre-smooth (zero
// start) has been run on b: the other steps, the residual, and its
// restriction into the next level's b.  Returns the buffer that holds x.
template <typename T, typename C, int NM>
__device__ int dk_pre(Ctx<T, NM>& cx, const DeepParams& P, int ell, const T* b) {
  const DeepLevel& L = P.lev[ell];
  const DeepLevel& N = P.lev[ell + 1];
  cx.sync();                                   // step 0's y, for the neighbours
  const int cur = dk_smooth<T, C, NM>(cx, P, ell, b, 0, 1, nullptr);
  const T* x = vp<T>(L, kYa + cur);
  T* r = vp<T>(L, kYa + 1 - cur);
  TP_FOR_MEMBER_CELLS(L.d.n) {
    int idx[3];
    coords32(L.d, c, idx);
    const size_t mo = (size_t)m * L.d.n;
    r[mo + c] = b[mo + c] - apply_batched(pk<C>(L, m), c, idx, L.d, x + mo);
  }
  cx.sync();
  dk_restrict<T, NM>(cx, L, N, r, vp<T>(N, kB));
  cx.sync();
  return cur;
}

// Step 0 of the zero-start pre-smooth of b on level ell (cells' own values
// only: the caller needs no barrier before it)
template <typename T, typename C, int NM>
__device__ void dk_pre_step0(Ctx<T, NM>& cx, const DeepParams& P, int ell, const T* b) {
  const DeepLevel& L = P.lev[ell];
  dk_cheb_step<T, C, NM>(cx, ell, P.n_levels - 1, P.degree, L, 0, b, nullptr, vp<T>(L, kYa));
}

// Second half: prolong the next level's correction, post-smooth into out
// (add + the smooth's result when `add` is given).
template <typename T, typename C, int NM>
__device__ void dk_post(Ctx<T, NM>& cx, const DeepParams& P, int ell, const T* b,
                        int cur, T* out, const T* add = nullptr) {
  const DeepLevel& L = P.lev[ell];
  const DeepLevel& N = P.lev[ell + 1];
  dk_prolong_add<T, NM>(cx, L, N, vp<T>(N, kOut), vp<T>(L, kYa + cur));
  cx.sync();
  dk_smooth<T, C, NM>(cx, P, ell, b, cur, 0, out, add);
}

template <typename T, typename C, int NM>
__global__ void __launch_bounds__(kDeepMaxThreads, 1)
    deep_kernel(const __grid_constant__ DeepParams P) {
  __shared__ ChebCoef<T> coef[NM * (kMaxLevels - 1) * kMaxDegree];
  __shared__ T red[NM * kMaxDots * 32];
  Ctx<T, NM> cx{cg::this_grid(), blockIdx.x * blockDim.x + threadIdx.x,
               gridDim.x * blockDim.x, 0, coef, red};
  // member m's level l, step s at [(m * (levels - 1) + l) * degree + s]
  const int per_member = (P.n_levels - 1) * P.degree;
  for (int i = threadIdx.x; i < NM * per_member; i += blockDim.x) {
    const int m = i / per_member, j = i - m * per_member;
    const T lam = static_cast<const T*>(P.lev[j / P.degree].lam)[m];
    cheb_scalars(lam, T(P.frac), T(P.safety), j % P.degree, &coef[i].theta,
                 &coef[i].c1, &coef[i].c2);
  }
  __syncthreads();

  int stage[kMaxLevels];
  int xbuf[kMaxLevels];     // the buffer that holds the pre-smoothed x
  T ksafe[kMaxLevels][NM];
  int ell = 0;
  stage[0] = 0;
  while (true) {
    const DeepLevel& L = P.lev[ell];
    const size_t n = (size_t)L.d.n;
    T* B = vp<T>(L, kB);
    T* OUT = vp<T>(L, kOut);
    bool done = false;
    if (ell == P.n_levels - 1) {
      dk_dense<T, NM>(cx, static_cast<const T*>(P.inv), B, OUT, (unsigned)L.d.n);
      cx.sync();
      done = true;
    } else if (stage[ell] == 0) {
      dk_pre_step0<T, C, NM>(cx, P, ell, B);
      xbuf[ell] = dk_pre<T, C, NM>(cx, P, ell, B);
      stage[ell] = 1;
    } else if (stage[ell] == 1) {
      if (L.kind == kSingle) {
        dk_post<T, C, NM>(cx, P, ell, B, xbuf[ell], OUT);
        done = true;
      } else if (L.kind == kW) {
        // W-cycle, first half: e1 = cycle(b); r1 = b - A e1 in one pass with
        // step 0 of the second cycle's pre-smooth (the same thread's cells)
        T* E1 = vp<T>(L, kE1);
        T* R1 = vp<T>(L, kR1);
        dk_post<T, C, NM>(cx, P, ell, B, xbuf[ell], E1);
        TP_FOR_MEMBER_CELLS(L.d.n) {
          int idx[3];
          coords32(L.d, c, idx);
          const size_t mc = m * n + c;
          R1[mc] = B[mc] - apply_batched(pk<C>(L, m), c, idx, L.d, E1 + m * n);
        }
        dk_pre_step0<T, C, NM>(cx, P, ell, R1);
        xbuf[ell] = dk_pre<T, C, NM>(cx, P, ell, R1);
        stage[ell] = 2;
      } else {
        // K-cycle, first half: e1 = cycle(b); flexible-CG step on it
        T* E1 = vp<T>(L, kE1);
        T* V1 = vp<T>(L, kV1);
        T* R1 = vp<T>(L, kR1);
        dk_post<T, C, NM>(cx, P, ell, B, xbuf[ell], E1);
        const T* da[2] = {nullptr, B};
        const T* de[2] = {E1, E1};
        T s[NM][2];
        dk_matvec_dots<T, C, NM, 2>(cx, L, E1, V1, da, de, s);   // rho1, alpha1
        dk_reduce<T, NM, 2>(cx, P, s);
        T a1[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const T safe = fabs(s[m][0]) > T(0) ? s[m][0] : T(1);
          ksafe[ell][m] = safe;
          a1[m] = s[m][1] / safe;
        }
        TP_FOR_MEMBER_CELLS(L.d.n) {
          const size_t mc = m * n + c;
          OUT[mc] = a1[m] * E1[mc];
          R1[mc] = B[mc] - a1[m] * V1[mc];
        }
        dk_pre_step0<T, C, NM>(cx, P, ell, R1);     // the same thread's cells
        xbuf[ell] = dk_pre<T, C, NM>(cx, P, ell, R1);
        stage[ell] = 2;
      }
    } else if (L.kind == kW) {
      // W-cycle, second half: out = e1 + cycle(r1), the sum written by the
      // post-smooth's last step
      dk_post<T, C, NM>(cx, P, ell, vp<T>(L, kR1), xbuf[ell], OUT, vp<T>(L, kE1));
      done = true;
    } else {
      // K-cycle, second half: e2 = cycle(r1), then the CG(2) combination
      T* E1 = vp<T>(L, kE1);
      T* V1 = vp<T>(L, kV1);
      T* R1 = vp<T>(L, kR1);
      T* E2 = vp<T>(L, kE2);
      T* V2 = vp<T>(L, kV2);
      dk_post<T, C, NM>(cx, P, ell, R1, xbuf[ell], E2);
      const T* da[3] = {V1, nullptr, R1};
      const T* de[3] = {E2, E2, E2};
      T s[NM][3];
      dk_matvec_dots<T, C, NM, 3>(cx, L, E2, V2, da, de, s);     // gamma, beta, alpha2
      dk_reduce<T, NM, 3>(cx, P, s);
      T a2[NM], g[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const T safe = ksafe[ell][m];
        const T rho2 = s[m][1] - s[m][0] * s[m][0] / safe;
        const T safe2 = fabs(rho2) > T(0) ? rho2 : T(1);
        a2[m] = s[m][2] / safe2;
        g[m] = s[m][0] / safe;
      }
      TP_FOR_MEMBER_CELLS(L.d.n) {
        const size_t mc = m * n + c;
        OUT[mc] = OUT[mc] + a2[m] * (E2[mc] - g[m] * E1[mc]);
      }
      cx.sync();
      done = true;
    }
    if (!done) {       // descend into the next level's correction
      ++ell;
      stage[ell] = 0;
    } else if (ell == 0) {
      break;
    } else {
      --ell;           // the parent resumes at its recorded stage
    }
  }
  if (P.barriers != nullptr && cx.gtid == 0) *P.barriers = cx.nbar;
}

template <typename T, typename C>
int launch_deep(DeepParams& P, int blocks, int threads, cudaStream_t st) {
  void* args[] = {&P};
  const void* fn = P.batch == 2 ? reinterpret_cast<const void*>(&deep_kernel<T, C, 2>)
                                : reinterpret_cast<const void*>(&deep_kernel<T, C, 1>);
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, 0, st);
}

}  // namespace tp

extern "C" {

// desc: kDescPerLevel int64 per level, host memory: packed, lam, the
// kNumVec vector pointers (b, out, e1, v1, r1, e2, v2, ya, yb, d), dim, n0,
// n1, n2, three coarsening factors, the cycle kind (0 single, 1 K, 2 W).
// Every pointer is member 0's of `batch` members (the layout above).
// partials: 3 * batch * blocks values of the working dtype.  barriers:
// nullable device int.  dtype: kernels/_lib.py: dtype_code.  A grid that
// cannot be co-resident, or an unknown cycle kind, is refused with an error.
int tp_deep_correction(int dtype, const long long* desc, int n_levels,
                       const void* inv, void* partials, int* barriers,
                       int degree, double frac, double safety, int blocks,
                       int threads, int batch, void* stream) {
  if (n_levels < 1 || n_levels > tp::kMaxLevels || degree < 1 ||
      degree > tp::kMaxDegree || blocks < 1 || threads < 32 ||
      threads > tp::kDeepMaxThreads || threads % 32 != 0 || batch < 1 ||
      batch > tp::kDeepMaxBatch)
    return (int)cudaErrorInvalidValue;
  tp::DeepParams P;
  P.inv = inv;
  P.partials = partials;
  P.barriers = barriers;
  P.frac = frac;
  P.safety = safety;
  P.degree = degree;
  P.n_levels = n_levels;
  P.batch = batch;
  for (int l = 0; l < n_levels; ++l) {
    const long long* q = desc + (long)l * tp::kDescPerLevel;
    tp::DeepLevel& L = P.lev[l];
    L.packed = reinterpret_cast<const void*>(q[0]);
    L.lam = reinterpret_cast<const void*>(q[1]);
    for (int k = 0; k < tp::kNumVec; ++k) L.vec[k] = reinterpret_cast<void*>(q[2 + k]);
    L.d = tp::make_dims((int)q[12], (int)q[13], (int)q[14], (int)q[15]);
    for (int a = 0; a < 3; ++a) L.fac[a] = (int)q[16 + a];
    L.kind = (int)q[19];
    if (L.kind < tp::kSingle || L.kind > tp::kW) return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return TP_DISPATCH_TC(dtype, tp::launch_deep, P, blocks, threads, st);
}

}  // extern "C"
