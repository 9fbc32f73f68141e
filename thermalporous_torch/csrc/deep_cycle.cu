// The whole multigrid coarse-grid correction below a level in one launch:
// K- or V-cycle recursion, Chebyshev smoothing, constant-transfer
// restriction and prolongation, and the dense coarsest-level solve.
//
// Replaces thermalporous_tpu/kernels/deep_cycle.py:deep_correction (289-365,
// math in _correction_math 209-268).  The W-cycle is not ported.
//
// What bounds it on the H100: latency, not bytes.  The subtree it walks is
// small (the flagship's pressure hierarchy below 36.3k cells is under 3 MB
// of coefficients and vectors in f32, L2-resident), but the recursion is a
// chain of several hundred dependent passes over small grids.  Run as
// separate kernels, each pass pays a launch (~5-10 us from the eager host
// loop) for a few microseconds of work.  The design:
//   - ONE thread block of 1024 threads walks the whole recursion; each pass
//     is a block-stride loop over the level's cells followed by
//     __syncthreads(), so nothing goes back to the host and nothing is
//     launched per pass;
//   - the recursion is an explicit loop over a per-level stage counter
//     (enter, after the first cycle, after the second K-cycle cycle), so
//     there is no device-side call stack;
//   - per-level vectors (b, out, e1, v1, r1, e2, v2, x, d, r) live in one
//     device scratch buffer that the wrapper allocates; a level's frame is
//     only ever active once at a time, so one set per level suffices;
//   - the K-cycle dot products are block reductions (warp shuffles, then
//     one warp over the per-warp sums), in the working dtype, as the plain
//     version's torch.dot;
//   - the dense coarsest solve is one warp per row of the inverse.
// A single SM does all the work, so on the larger entry levels the kernel
// is slower than the device could be; a cooperative or cluster form is
// later work.
//
// Every pass follows the plain version's order of operations
// (thermalporous_torch/kernels/deep_cycle.py:deep_correction_plain), so
// with --fmad=false only the dot products and the dense solve (summation
// order) round differently.

#include "common.cuh"

namespace tp {

constexpr int kDeepThreads = 1024;
constexpr int kMaxLevels = 16;
constexpr int kDescPerLevel = 20;

enum Vec { kB, kOut, kE1, kV1, kR1, kE2, kV2, kX, kD, kR, kNumVec };

struct DeepLevel {
  const void* packed;  // (2*dim+1, n) scalar stencil
  const void* lam;     // 0-dim lambda_max on the device (unused on the coarsest)
  void* vec[kNumVec];
  Dims d;
  int fac[3];          // coarsening factors to the next level
  int kcycle;          // 1: this level runs the K-cycle
};

struct DeepParams {
  const void* inv;     // dense inverse of the coarsest operator
  double frac;
  double safety;
  int degree;
  int n_levels;
  DeepLevel lev[kMaxLevels];
};

#define TP_FOR_CELLS(n) for (long c = threadIdx.x; c < (n); c += blockDim.x)

template <typename T>
__device__ __forceinline__ T* vp(const DeepLevel& L, int k) {
  return static_cast<T*>(L.vec[k]);
}

// x <- smooth(b, x) with `degree` Chebyshev steps (x zero: zero start);
// the result goes to `out`, which may be the level's x buffer itself.
template <typename T>
__device__ void dk_cheb(const DeepLevel& L, const T* b, bool zero_start,
                        T* out, T frac, T safety, int degree) {
  const T* p = static_cast<const T*>(L.packed);
  const Dims& d = L.d;
  T* x = vp<T>(L, kX);
  T* dd = vp<T>(L, kD);
  const T lam = *static_cast<const T*>(L.lam);
  auto xv = [=](long i) { return x[i]; };
  T theta, c1, c2;
  cheb_scalars(lam, frac, safety, 0, &theta, &c1, &c2);
  TP_FOR_CELLS(d.n) {
    const T inv_diag = T(1) / p[c];
    T z;
    if (zero_start) {
      z = inv_diag * b[c];
    } else {
      int idx[3];
      d.coords(c, idx);
      z = inv_diag * (b[c] - apply_scalar(p, c, idx, d, xv));
    }
    dd[c] = z / theta;
  }
  __syncthreads();
  for (int s = 1; s < degree; ++s) {
    cheb_scalars(lam, frac, safety, s, &theta, &c1, &c2);
    TP_FOR_CELLS(d.n) x[c] = (zero_start && s == 1 ? T(0) : x[c]) + dd[c];
    __syncthreads();
    TP_FOR_CELLS(d.n) {
      int idx[3];
      d.coords(c, idx);
      const T inv_diag = T(1) / p[c];
      const T z = inv_diag * (b[c] - apply_scalar(p, c, idx, d, xv));
      dd[c] = c1 * dd[c] + c2 * z;
    }
    __syncthreads();
  }
  TP_FOR_CELLS(d.n) out[c] = (zero_start && degree == 1 ? T(0) : x[c]) + dd[c];
  __syncthreads();
}

// y = A v on level L
template <typename T>
__device__ void dk_matvec(const DeepLevel& L, const T* v, T* y) {
  const T* p = static_cast<const T*>(L.packed);
  const Dims& d = L.d;
  auto vv = [=](long i) { return v[i]; };
  TP_FOR_CELLS(d.n) {
    int idx[3];
    d.coords(c, idx);
    y[c] = apply_scalar(p, c, idx, d, vv);
  }
  __syncthreads();
}

// Summation restriction of r (fine level F) into rc (coarse level C): the
// pair sums of axis 0 first, then axis 1, then axis 2, out-of-range cells
// zero (the plain version's padded block sums, in its order).
template <typename T>
__device__ void dk_restrict(const DeepLevel& F, const DeepLevel& C, const T* r,
                            T* rc) {
  const Dims& f = F.d;
  const int* fac = F.fac;
  TP_FOR_CELLS(C.d.n) {
    int I[3];
    C.d.coords(c, I);
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
            s0[k0] = r[i0 * f.stride[0] + i1 * f.stride[1] + i2];
        }
        s1[k1] = fac[0] == 2 ? s0[0] + s0[1] : s0[0];
      }
      s2[k2] = fac[1] == 2 ? s1[0] + s1[1] : s1[0];
    }
    rc[c] = fac[2] == 2 ? s2[0] + s2[1] : s2[0];
  }
  __syncthreads();
}

// x += P ec: piecewise-constant prolongation from C back to F
template <typename T>
__device__ void dk_prolong_add(const DeepLevel& F, const DeepLevel& C,
                               const T* ec, T* x) {
  const Dims& f = F.d;
  const int* fac = F.fac;
  TP_FOR_CELLS(f.n) {
    int i[3];
    f.coords(c, i);
    long cc = 0;
    for (int a = 0; a < 3; ++a) cc += (long)(fac[a] == 2 ? i[a] / 2 : i[a]) * C.d.stride[a];
    x[c] = x[c] + ec[cc];
  }
  __syncthreads();
}

// out = inv b on the coarsest level: one warp per row
template <typename T>
__device__ void dk_dense(const T* inv, const T* b, T* out, long n) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (long i = threadIdx.x >> 5; i < n; i += nw) {
    T acc = T(0);
    for (long j = lane; j < n; j += 32) acc = acc + inv[i * n + j] * b[j];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
}

// K dot products <a_k, b_k> over n cells, every thread gets the sums
template <typename T, int K>
__device__ void dk_dots(const T* const (&a)[K], const T* const (&b)[K], long n,
                        T (&out)[K]) {
  __shared__ double red_store[3 * 32];
  T* red = reinterpret_cast<T*>(red_store);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  TP_FOR_CELLS(n) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = acc[k] + a[k][c] * b[k][c];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0) red[k * 32 + warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T v = lane < nw ? red[k * 32 + lane] : T(0);
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[k * 32] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = red[k * 32];
  __syncthreads();
}

// First half of a cycle on level ell: pre-smooth from zero into x, the
// residual, and its restriction into the next level's b.
template <typename T>
__device__ void dk_pre(const DeepParams& P, int ell, const T* b) {
  const DeepLevel& L = P.lev[ell];
  const DeepLevel& N = P.lev[ell + 1];
  T* x = vp<T>(L, kX);
  T* r = vp<T>(L, kR);
  dk_cheb<T>(L, b, true, x, T(P.frac), T(P.safety), P.degree);
  const T* p = static_cast<const T*>(L.packed);
  auto xv = [=](long i) { return x[i]; };
  TP_FOR_CELLS(L.d.n) {
    int idx[3];
    L.d.coords(c, idx);
    r[c] = b[c] - apply_scalar(p, c, idx, L.d, xv);
  }
  __syncthreads();
  dk_restrict<T>(L, N, r, vp<T>(N, kB));
}

// Second half: prolong the next level's correction, post-smooth into out.
template <typename T>
__device__ void dk_post(const DeepParams& P, int ell, const T* b, T* out) {
  const DeepLevel& L = P.lev[ell];
  const DeepLevel& N = P.lev[ell + 1];
  dk_prolong_add<T>(L, N, vp<T>(N, kOut), vp<T>(L, kX));
  dk_cheb<T>(L, b, false, out, T(P.frac), T(P.safety), P.degree);
}

template <typename T>
__global__ void __launch_bounds__(kDeepThreads)
    deep_kernel(const __grid_constant__ DeepParams P) {
  int stage[kMaxLevels];
  T ksafe[kMaxLevels];
  int ell = 0;
  stage[0] = 0;
  while (true) {
    const DeepLevel& L = P.lev[ell];
    T* B = vp<T>(L, kB);
    T* OUT = vp<T>(L, kOut);
    bool done = false;
    if (ell == P.n_levels - 1) {
      dk_dense<T>(static_cast<const T*>(P.inv), B, OUT, L.d.n);
      done = true;
    } else if (stage[ell] == 0) {
      dk_pre<T>(P, ell, B);
      stage[ell] = 1;
    } else if (stage[ell] == 1) {
      if (!L.kcycle) {
        dk_post<T>(P, ell, B, OUT);
        done = true;
      } else {
        // K-cycle, first half: e1 = cycle(b); flexible-CG step on it
        T* E1 = vp<T>(L, kE1);
        T* V1 = vp<T>(L, kV1);
        T* R1 = vp<T>(L, kR1);
        dk_post<T>(P, ell, B, E1);
        dk_matvec<T>(L, E1, V1);
        const T* da[2] = {V1, B};
        const T* db[2] = {E1, E1};
        T s[2];
        dk_dots<T, 2>(da, db, L.d.n, s);   // rho1, alpha1
        const T safe = fabs(s[0]) > T(0) ? s[0] : T(1);
        ksafe[ell] = safe;
        const T a1 = s[1] / safe;
        TP_FOR_CELLS(L.d.n) {
          OUT[c] = a1 * E1[c];
          R1[c] = B[c] - a1 * V1[c];
        }
        __syncthreads();
        dk_pre<T>(P, ell, R1);
        stage[ell] = 2;
      }
    } else {
      // K-cycle, second half: e2 = cycle(r1), then the CG(2) combination
      T* E1 = vp<T>(L, kE1);
      T* V1 = vp<T>(L, kV1);
      T* R1 = vp<T>(L, kR1);
      T* E2 = vp<T>(L, kE2);
      T* V2 = vp<T>(L, kV2);
      dk_post<T>(P, ell, R1, E2);
      dk_matvec<T>(L, E2, V2);
      const T* da[3] = {V1, V2, R1};
      const T* db[3] = {E2, E2, E2};
      T s[3];
      dk_dots<T, 3>(da, db, L.d.n, s);     // gamma, beta, alpha2
      const T safe = ksafe[ell];
      const T rho2 = s[1] - s[0] * s[0] / safe;
      const T safe2 = fabs(rho2) > T(0) ? rho2 : T(1);
      const T a2 = s[2] / safe2;
      const T g = s[0] / safe;
      TP_FOR_CELLS(L.d.n) OUT[c] = OUT[c] + a2 * (E2[c] - g * E1[c]);
      __syncthreads();
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
}

}  // namespace tp

extern "C" {

// desc: kDescPerLevel int64 per level, host memory: packed, lam, the
// kNumVec vector pointers (b, out, e1, v1, r1, e2, v2, x, d, r), dim, n0,
// n1, n2, three coarsening factors, kcycle.  dtype: 0 = float32, 1 = float64.
int tp_deep_correction(int dtype, const long long* desc, int n_levels,
                       const void* inv, int degree, double frac, double safety,
                       void* stream) {
  if (n_levels < 1 || n_levels > tp::kMaxLevels) return (int)cudaErrorInvalidValue;
  tp::DeepParams P;
  P.inv = inv;
  P.frac = frac;
  P.safety = safety;
  P.degree = degree;
  P.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    const long long* q = desc + (long)l * tp::kDescPerLevel;
    tp::DeepLevel& L = P.lev[l];
    L.packed = reinterpret_cast<const void*>(q[0]);
    L.lam = reinterpret_cast<const void*>(q[1]);
    for (int k = 0; k < tp::kNumVec; ++k) L.vec[k] = reinterpret_cast<void*>(q[2 + k]);
    L.d = tp::make_dims((int)q[12], (int)q[13], (int)q[14], (int)q[15]);
    for (int a = 0; a < 3; ++a) L.fac[a] = (int)q[16 + a];
    L.kcycle = (int)q[19];
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    tp::deep_kernel<float><<<1, tp::kDeepThreads, 0, st>>>(P);
  else
    tp::deep_kernel<double><<<1, tp::kDeepThreads, 0, st>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
