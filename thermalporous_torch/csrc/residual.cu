// Fused backward-Euler residual and its forward derivative (J(u)·v), for the
// two-phase (p, T, S_w) and the single-phase (p, T) model.
//
// Replaces thermalporous_tpu/kernels/residual_pallas.py:
//   tp_twophase_residual, tp_singlephase_residual <- fused_residual (185-193;
//       kernel body 121-154), which runs the model's jnp residual on VMEM
//       tiles;
//   tp_twophase_jvp, tp_singlephase_jvp <- fused_jvp (196-213), the same
//       body under jax.jvp: the Krylov operator of krylov_op="jvp".
// All four are instantiations of one kernel, model_kernel.
// Here the physics is inlined: the correlations of physics/props.py and
// physics/relperm.py, the cell terms and well sources of models/twophase.py
// (38-86) and models/singlephase.py (28-61), and their face fluxes.  The
// device physics is written once, templated on its scalar type S: S = T
// gives the residual, S = Dual<T> (csrc/dual.cuh) gives the residual's
// value and tangent in one pass, of which the JVP kernels write the tangent.
//
// What bounds them on the H100: bytes.  Per cell the residual reads 2*nc
// state values and 2*dim+7 field values and writes nc results (about 88 B
// in f32 for the 3D two-phase model), against some 300 flops and two
// transcendentals (exp10 for mu_w, exp for mu_o); the JVP reads u, v and the
// fields (it needs no u_old: the old accumulation is a constant, whose
// tangent is zero) and writes J·v, the same 88 B for about three times the
// arithmetic -- still under the machine balance of ~20 flop/byte.  The
// plain PyTorch versions are tens of elementwise passes over device memory
// (torch.func.jvp about twice as many), so one pass is what matters, and
// within that pass the arithmetic: a kernel that evaluates every face from
// scratch on both of its cells does six times the function's
// transcendentals and divisions and is bound by them, not by memory.
// Design:
//   - whatever of a face's arithmetic depends on ONE cell -- the densities
//     and the phase mobilities rho*kr/mu (single-phase: rho and mu) -- is
//     computed once per cell (M::props) as S, value and tangent, and a face
//     reads two cells' properties: potential difference, upwind choice,
//     products;
//   - a block owns a tile of the plane spanned by the last one or two grid
//     axes (ty rows of tz consecutive cells, one thread per cell, coalesced
//     along the last axis) and marches through lx planes along axis 0.  A
//     thread keeps its column's properties of the current and the next
//     plane in registers, so the face along axis 0 costs no exchange, and
//     the flux it subtracts at the next plane is the very value it added at
//     this one, kept in a register.  Within the plane a thread publishes its
//     cell's properties and its "+" face fluxes in shared memory; the "-"
//     faces come from the neighbour's published flux.  Only the tile's ring
//     (the neighbours just outside it in the plane) has its properties
//     computed again, and only the tile's low sides and a chunk's first
//     plane compute a face again.  No atomics: every run gives the same
//     bits, and the flux a cell subtracts is the value its neighbour adds;
//   - the planes alternate between two shared-memory buffers: two block
//     barriers a plane;
//   - 32-bit indices (n < 2^31); the physical constants come by value in a
//     struct, the time step by value, so there is no host round trip;
//   - a face on the last slice of an axis has no second cell: its flux is
//     zero (the plain version multiplies a phantom neighbour's flux by the
//     zero transmissibility of the full-shape layout).
// The tile (ty, tz) and the chunk lx come from the wrapper
// (kernels/residual.py: model_plan).  Each expression keeps the plain
// version's operands and order, and the tangent rules are torch's
// forward-mode formulas (csrc/dual.cuh); built with --fmad=false, f64
// results then differ from the plain version only through exp10/exp (CUDA's
// are within 1-2 ulp of the CPU libm), which the JVP's tangents of mu_w and
// mu_o inherit from the primal values.

#include "common.cuh"
#include "dual.cuh"

namespace tp {

// Constants of PhysicalParams / CoreyRelPerm / Grid in the working dtype
// (rounded once from the host's doubles, as the plain version rounds them).
// The single-phase kernels read only the water, rock and grid constants.
template <typename T>
struct ModelParams {
  T p_ref, T_ref, rho_w_ref, c_w, beta_w, cp_w;
  T rho_o_ref, c_o, beta_o, cp_o, mu_o_ref, b_o, inv_T_mu_ref;
  T rho_c_rock, vol, gravity;
  T ddepth[3];
  T s_wr, se_denom, n_w, n_o, k_rw_end, k_ro_end;
  T mu_w_coef, mu_w_num, mu_w_shift;
};

// Number of doubles the host passes, in the struct's field order.
constexpr int kNumParams = 28;

template <typename T>
ModelParams<T> params_from(const double* h) {
  static_assert(sizeof(ModelParams<T>) == kNumParams * sizeof(T),
                "ModelParams must be kNumParams packed scalars");
  ModelParams<T> q;
  T* f = reinterpret_cast<T*>(&q);
  for (int i = 0; i < kNumParams; ++i) f[i] = T(h[i]);
  return q;
}

template <typename T>
struct Props {
  ModelParams<T> q;

  template <typename S>
  __device__ S rho_w(S p, S t) const {
    return q.rho_w_ref * (T(1) + q.c_w * (p - q.p_ref) - q.beta_w * (t - q.T_ref));
  }
  template <typename S>
  __device__ S rho_o(S p, S t) const {
    return q.rho_o_ref * (T(1) + q.c_o * (p - q.p_ref) - q.beta_o * (t - q.T_ref));
  }
  // 2.414e-5 * 10 ** (247.8 / (T - 140))
  template <typename S>
  __device__ S mu_w(S t) const {
    return q.mu_w_coef * exp10_(rdiv(q.mu_w_num, t - q.mu_w_shift));
  }
  template <typename S>
  __device__ S mu_o(S t) const {
    return q.mu_o_ref * exp_(q.b_o * (rdiv(T(1), t) - q.inv_T_mu_ref));
  }
  template <typename S>
  __device__ S ipow(S x, T n) const { return n == T(2) ? x * x : pow_(x, n); }
  template <typename S>
  __device__ S se(S s) const { return clip01((s - q.s_wr) / q.se_denom); }
  template <typename S>
  __device__ S krw(S s) const { return q.k_rw_end * ipow(se(s), q.n_w); }
  template <typename S>
  __device__ S kro(S s) const { return q.k_ro_end * ipow(T(1) - se(s), q.n_o); }
  template <typename S>
  __device__ S energy_tp(S p, S t, S s, T phi) const {
    const S fluid = s * rho_w(p, t) * q.cp_w + (T(1) - s) * rho_o(p, t) * q.cp_o;
    return (T(1) - phi) * q.rho_c_rock * t + phi * fluid * t;
  }
  template <typename S>
  __device__ S energy_sp(S p, S t, T phi) const {
    return (T(1) - phi) * q.rho_c_rock * t + phi * rho_w(p, t) * q.cp_w * t;
  }
};

// Field values of one cell: porosity and the six well fields.
template <typename T>
struct CellFields {
  T phi, wi, pbh, tinj, has_tinj, qrate, qheat;
};

// Two-phase model: equations (water, energy, oil).
struct TwoPhase {
  static constexpr int NC = 3;
  // cell properties: p, T, rho_w, rho_o, lam_w, lam_o, S_w; a face reads the
  // first NPF of its two cells
  static constexpr int NP = 7;
  static constexpr int NPF = 6;

  template <typename T, typename S>
  __device__ static void props(const Props<T>& pr, const S* x, S* c) {
    c[0] = x[0];
    c[1] = x[1];
    c[2] = pr.rho_w(x[0], x[1]);
    c[3] = pr.rho_o(x[0], x[1]);
    c[4] = c[2] * pr.krw(x[2]) / pr.mu_w(x[1]);
    c[5] = c[3] * pr.kro(x[2]) / pr.mu_o(x[1]);
    c[6] = x[2];
  }

  // accumulation minus sources; kOld = false leaves out the old accumulation
  // (a constant: the JVP kernels need only the tangent)
  template <typename T, typename S, bool kOld>
  __device__ static void cell(const Props<T>& pr, const S* c, const T* x0,
                              const CellFields<T>& f, T dt, S* r) {
    const auto& q = pr.q;
    const S p = c[0], t = c[1], s = c[6];
    const S rho_w = c[2], rho_o = c[3];
    T old_w = T(0), old_o = T(0), old_e = T(0);
    if constexpr (kOld) {
      const T rho_w0 = pr.rho_w(x0[0], x0[1]), rho_o0 = pr.rho_o(x0[0], x0[1]);
      old_w = rho_w0 * x0[2];
      old_o = rho_o0 * (T(1) - x0[2]);
      old_e = pr.energy_tp(x0[0], x0[1], x0[2], f.phi);
    }
    const S acc_w = q.vol * f.phi * (rho_w * s - old_w) / dt;
    const S acc_o = q.vol * f.phi * (rho_o * (T(1) - s) - old_o) / dt;
    const S acc_e = q.vol * (pr.energy_tp(p, t, s, f.phi) - old_e) / dt;

    // Peaceman BHP wells, then rate wells and heaters
    const S dp = f.pbh - p;
    const bool inflow = val(dp) >= T(0) && f.has_tinj > T(0.5);
    const S lam_w = c[4];
    const S lam_o = c[5];
    S q_w, q_o, q_e;
    if (inflow) {
      const S tinj = S(f.tinj);
      const S lam_w_inj = pr.rho_w(p, tinj) / pr.mu_w(tinj);
      q_w = f.wi * dp * lam_w_inj;
      q_o = f.wi * dp * T(0);
      q_e = q_w * q.cp_w * f.tinj;
    } else {
      q_w = f.wi * dp * lam_w;
      q_o = f.wi * dp * lam_o;
      q_e = (q_w * q.cp_w + q_o * q.cp_o) * t;
    }
    const S t_rate = f.has_tinj > T(0.5) ? S(f.tinj) : t;
    const S fw = lam_w / (lam_w + lam_o + T(1e-30));
    if (f.qrate >= T(0)) {
      q_w = q_w + f.qrate;
      q_o = q_o + T(0);
      q_e = q_e + f.qrate * q.cp_w * t_rate;
    } else {
      q_w = q_w + f.qrate * fw;
      q_o = q_o + f.qrate * (T(1) - fw);
      q_e = q_e + (f.qrate * fw * q.cp_w + f.qrate * (T(1) - fw) * q.cp_o) * t;
    }
    q_e = q_e + f.qheat;
    r[0] = acc_w - q_w;
    r[1] = acc_e - q_e;
    r[2] = acc_o - q_o;
  }

  // fluxes (water, energy, oil) through the face L -> R along one axis,
  // from the two cells' properties
  template <typename T, typename S>
  __device__ static void face(const Props<T>& pr, T ddepth, const S* l, const S* r,
                              T tgeo, T tcond, S* f) {
    const auto& q = pr.q;
    const S dphi_w = l[0] - r[0] - T(0.5) * (l[2] + r[2]) * q.gravity * ddepth;
    const bool up_w = val(dphi_w) >= T(0);
    const S lam_w = up_w ? l[4] : r[4];
    const S f_w = tgeo * lam_w * dphi_w;
    const S dphi_o = l[0] - r[0] - T(0.5) * (l[3] + r[3]) * q.gravity * ddepth;
    const bool up_o = val(dphi_o) >= T(0);
    const S lam_o = up_o ? l[5] : r[5];
    const S f_o = tgeo * lam_o * dphi_o;
    const S t_up_w = up_w ? l[1] : r[1];
    const S t_up_o = up_o ? l[1] : r[1];
    f[0] = f_w;
    f[1] = q.cp_w * t_up_w * f_w + q.cp_o * t_up_o * f_o + tcond * (l[1] - r[1]);
    f[2] = f_o;
  }
};

// Single-phase model: equations (mass, energy).
struct SinglePhase {
  static constexpr int NC = 2;
  // cell properties: p, T, rho_w, mu_w
  static constexpr int NP = 4;
  static constexpr int NPF = 4;

  template <typename T, typename S>
  __device__ static void props(const Props<T>& pr, const S* x, S* c) {
    c[0] = x[0];
    c[1] = x[1];
    c[2] = pr.rho_w(x[0], x[1]);
    c[3] = pr.mu_w(x[1]);
  }

  template <typename T, typename S, bool kOld>
  __device__ static void cell(const Props<T>& pr, const S* c, const T* x0,
                              const CellFields<T>& f, T dt, S* r) {
    const auto& q = pr.q;
    const S p = c[0], t = c[1];
    T rho0 = T(0), old_e = T(0);
    if constexpr (kOld) {
      rho0 = pr.rho_w(x0[0], x0[1]);
      old_e = pr.energy_sp(x0[0], x0[1], f.phi);
    }
    const S acc_m = q.vol * f.phi * (c[2] - rho0) / dt;
    const S acc_e = q.vol * (pr.energy_sp(p, t, f.phi) - old_e) / dt;

    // Peaceman BHP wells, upwinded by the flow's sign: inflow carries the
    // injected fluid at T_inj, outflow the local T
    const S dp = f.pbh - p;
    const bool injects = val(dp) >= T(0) && f.has_tinj > T(0.5);
    S t_up, lam;
    if (injects) {
      t_up = S(f.tinj);
      lam = pr.rho_w(p, t_up) / pr.mu_w(t_up);
    } else {
      t_up = t;
      lam = c[2] / c[3];
    }
    S q_m = f.wi * lam * dp;
    S q_e = q_m * q.cp_w * t_up;
    // rate wells: a fixed mass rate; injection carries T_inj
    const S t_rate = f.has_tinj > T(0.5) ? S(f.tinj) : t;
    q_m = q_m + f.qrate;
    q_e = q_e + f.qrate * q.cp_w * (f.qrate >= T(0) ? t_rate : t);
    q_e = q_e + f.qheat;
    r[0] = acc_m - q_m;
    r[1] = acc_e - q_e;
  }

  // fluxes (mass, energy) through the face L -> R along one axis
  template <typename T, typename S>
  __device__ static void face(const Props<T>& pr, T ddepth, const S* l, const S* r,
                              T tgeo, T tcond, S* f) {
    const auto& q = pr.q;
    const S dphi = l[0] - r[0] - T(0.5) * (l[2] + r[2]) * q.gravity * ddepth;
    const bool up = val(dphi) >= T(0);
    const S rho_up = up ? l[2] : r[2];
    const S mu_up = up ? l[3] : r[3];
    const S t_up = up ? l[1] : r[1];
    const S f_m = tgeo * rho_up / mu_up * dphi;
    f[0] = f_m;
    f[1] = q.cp_w * t_up * f_m + tcond * (l[1] - r[1]);
  }
};

constexpr int kModelThreads = 256;

// The tiling of model_kernel (kernels/residual.py: model_plan).  The grid is
// seen as (e0, e1, e2) with e1 = 1 in 2D: a block marches along axis 0
// through lx planes of a tile of ty x tz cells of the (e1, e2) plane.
struct TilePlan {
  unsigned n;
  int dim;
  int e0, e1, e2;
  int ty, tz, lx;
  int tiles_y, tiles_z;
};

// Bytes of dynamic shared memory of one block: two buffers, each the face
// properties of the tile and its ring ((ty + 2) x (tz + 2) cells; no ring
// rows in 2D) as S, and the tile's "+" fluxes along the two in-plane axes
// as T.
inline size_t model_smem(const TilePlan& tp, int npf, int nc, size_t size_s, size_t size_t_) {
  const size_t hp = (size_t)(tp.ty + (tp.dim == 3 ? 2 : 0)) * (tp.tz + 2);
  return 2 * (npf * hp * size_s + 2 * nc * (size_t)tp.ty * tp.tz * size_t_);
}

// The residual (S = T: reads u and u_old, writes R) or its JVP
// (S = Dual<T>: reads u and v, writes J(u) v) of model M.  u, v, u_old,
// out: (NC, n); fields: (2*dim+7, n) = [tgeo_a.., tcond_a.., phi, wi, pbh,
// tinj, has_tinj, qrate, qheat].  The sum per cell runs in the plain
// version's order: cell terms, then per axis + F(i -> i+1) - F(i-1 -> i).
template <typename T, typename S, typename M>
__global__ void __launch_bounds__(kModelThreads)
    model_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ u_old, const T* __restrict__ fields,
                 T* __restrict__ out, T dt, ModelParams<T> q, TilePlan tp) {
  constexpr int NC = M::NC, NP = M::NP, NPF = M::NPF;
  constexpr bool kJvp = is_dual<S>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Props<T> pr{q};
  const unsigned n = tp.n;
  const int dim = tp.dim;
  const int py = dim == 3 ? 1 : 0;             // ring rows below and above the tile
  const int hz = tp.tz + 2;                    // row length of the tile with its ring
  const int hp = (tp.ty + 2 * py) * hz;        // cells of the tile with its ring
  const int tcells = tp.ty * tp.tz;
  S* pbuf = reinterpret_cast<S*>(smem_raw);                 // [2][NPF][hp]
  T* fbuf = reinterpret_cast<T*>(pbuf + 2 * NPF * hp);      // [2][2][NC][tcells]

  const int tid = (int)threadIdx.x;
  int blk = (int)blockIdx.x;
  const int bz = blk % tp.tiles_z;
  blk /= tp.tiles_z;
  const int by = blk % tp.tiles_y;
  const int bx = blk / tp.tiles_y;
  const int ly = tid / tp.tz, lz = tid - ly * tp.tz;
  const int y0 = by * tp.ty, z0 = bz * tp.tz;
  const int y = y0 + ly, z = z0 + lz;
  const bool active = tid < tcells && y < tp.e1 && z < tp.e2;
  const int x_begin = bx * tp.lx;
  const int x_end = min(x_begin + tp.lx, tp.e0);
  const unsigned s0 = (unsigned)tp.e1 * (unsigned)tp.e2, s1 = (unsigned)tp.e2;

  // model axes: the marching axis is 0, the in-plane row axis 1 (3D only),
  // the contiguous axis dim - 1
  const int az = dim - 1;
  const T* tg0 = fields;
  const T* tc0 = fields + (size_t)dim * n;
  const T* tgy = fields + (size_t)n;
  const T* tcy = fields + (size_t)(dim + 1) * n;
  const T* tgz = fields + (size_t)az * n;
  const T* tcz = fields + (size_t)(dim + az) * n;
  const T* wf = fields + (size_t)(2 * dim) * n;   // phi, then the six well fields

  auto state = [&](unsigned c, S* xs) {
#pragma unroll
    for (int i = 0; i < NC; ++i) xs[i] = load<S>(u, v, (long)i * n + c);
  };
  auto neighbour = [&](const S* p, int h, S* nb) {
#pragma unroll
    for (int k = 0; k < NPF; ++k) nb[k] = p[k * hp + h];
  };

  S cur[NP], nxt[NP];
  T fxp[NC];          // the flux through the face x-1 -> x of this thread's column
  unsigned c = 0;
#pragma unroll
  for (int i = 0; i < NC; ++i) fxp[i] = T(0);
  if (active) {
    c = ((unsigned)x_begin * (unsigned)tp.e1 + (unsigned)y) * (unsigned)tp.e2 + (unsigned)z;
    S xs[NC];
    state(c, xs);
    M::props(pr, xs, cur);
    if (x_begin > 0) {
      // a chunk's first plane computes the face below it again
      S prev[NP], f[NC];
      state(c - s0, xs);
      M::props(pr, xs, prev);
      M::face(pr, q.ddepth[0], prev, cur, tg0[c - s0], tc0[c - s0], f);
#pragma unroll
      for (int i = 0; i < NC; ++i) fxp[i] = out_part(f[i]);
    }
  }

  const int hown = (ly + py) * hz + lz + 1;    // this thread's cell among tile and ring
  const int ring = 2 * tp.ty + 2 * py * tp.tz;
  for (int x = x_begin; x < x_end; ++x, c += s0) {
    const int sel = (x - x_begin) & 1;
    S* P = pbuf + sel * NPF * hp;
    T* F = fbuf + sel * 2 * NC * tcells;
    const bool has_next = x + 1 < tp.e0;
    // (1) this column's properties at the next plane
    if (active && has_next) {
      S xs[NC];
      state(c + s0, xs);
      M::props(pr, xs, nxt);
    }
    // (2) publish this cell's properties; the ring's are computed again:
    // first the cells before and after each row, then the rows below and
    // above the tile
    if (active) {
#pragma unroll
      for (int k = 0; k < NPF; ++k) P[k * hp + hown] = cur[k];
    }
    for (int k = tid; k < ring; k += (int)blockDim.x) {
      int hy, hx;
      if (k < 2 * tp.ty) {
        hy = (k >> 1) + py;
        hx = (k & 1) ? tp.tz + 1 : 0;
      } else {
        const int m = k - 2 * tp.ty;
        hy = m < tp.tz ? 0 : tp.ty + 1;
        hx = (m < tp.tz ? m : m - tp.tz) + 1;
      }
      const int yy = y0 + hy - py, zz = z0 + hx - 1;
      if (yy < 0 || yy >= tp.e1 || zz < 0 || zz >= tp.e2) continue;
      const unsigned cc =
          ((unsigned)x * (unsigned)tp.e1 + (unsigned)yy) * (unsigned)tp.e2 + (unsigned)zz;
      S xs[NC], pp[NP];
      state(cc, xs);
      M::props(pr, xs, pp);
#pragma unroll
      for (int k2 = 0; k2 < NPF; ++k2) P[k2 * hp + hy * hz + hx] = pp[k2];
    }
    __syncthreads();
    // (3) the "+" faces of this cell
    T fx[NC], fy[NC], fz[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) fx[i] = fy[i] = fz[i] = T(0);
    if (active) {
      S f[NC], nb[NPF];
      if (has_next) {
        M::face(pr, q.ddepth[0], cur, nxt, tg0[c], tc0[c], f);
#pragma unroll
        for (int i = 0; i < NC; ++i) fx[i] = out_part(f[i]);
      }
      if (py && y + 1 < tp.e1) {
        neighbour(P, hown + hz, nb);
        M::face(pr, q.ddepth[1], cur, nb, tgy[c], tcy[c], f);
#pragma unroll
        for (int i = 0; i < NC; ++i) fy[i] = out_part(f[i]);
      }
      if (z + 1 < tp.e2) {
        neighbour(P, hown + 1, nb);
        M::face(pr, q.ddepth[az], cur, nb, tgz[c], tcz[c], f);
#pragma unroll
        for (int i = 0; i < NC; ++i) fz[i] = out_part(f[i]);
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        F[i * tcells + tid] = fy[i];
        F[(NC + i) * tcells + tid] = fz[i];
      }
    }
    __syncthreads();
    // (4) cell terms, then the faces in the plain version's order
    if (active) {
      T x0[NC];
      if constexpr (!kJvp) {
#pragma unroll
        for (int i = 0; i < NC; ++i) x0[i] = u_old[(size_t)i * n + c];
      }
      const CellFields<T> cf{wf[c], wf[(size_t)n + c], wf[(size_t)2 * n + c],
                             wf[(size_t)3 * n + c], wf[(size_t)4 * n + c],
                             wf[(size_t)5 * n + c], wf[(size_t)6 * n + c]};
      S r[NC];
      M::template cell<T, S, !kJvp>(pr, cur, x0, cf, dt, r);
      T acc[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = out_part(r[i]) + fx[i];
      if (x > 0) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = acc[i] - fxp[i];
      }
      if (py) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = acc[i] + fy[i];
        if (y > 0) {
          if (ly > 0) {
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[i] = acc[i] - F[i * tcells + tid - tp.tz];
          } else {
            // the tile's first row: the face from the ring cell, again
            S f[NC], nb[NPF];
            neighbour(P, hown - hz, nb);
            M::face(pr, q.ddepth[1], nb, cur, tgy[c - s1], tcy[c - s1], f);
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[i] = acc[i] - out_part(f[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = acc[i] + fz[i];
      if (z > 0) {
        if (lz > 0) {
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[i] = acc[i] - F[(NC + i) * tcells + tid - 1];
        } else {
          S f[NC], nb[NPF];
          neighbour(P, hown - 1, nb);
          M::face(pr, q.ddepth[az], nb, cur, tgz[c - 1], tcz[c - 1], f);
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[i] = acc[i] - out_part(f[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) out[(size_t)i * n + c] = acc[i];
#pragma unroll
      for (int i = 0; i < NC; ++i) fxp[i] = fx[i];
      if (has_next) {
#pragma unroll
        for (int k = 0; k < NP; ++k) cur[k] = nxt[k];
      }
    }
  }
}

// One instantiation's launch: more than 48 KB of dynamic shared memory must
// be opted in to, per function and device.
template <typename T, typename S, typename M>
int launch_one(const T* u, const T* v, const T* u_old, const T* fields, T* out, T dt,
               const ModelParams<T>& q, const TilePlan& tp, int blocks, int threads,
               cudaStream_t st) {
  const size_t smem = model_smem(tp, M::NPF, M::NC, sizeof(S), sizeof(T));
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (smem > allowed[dev]) {
      e = cudaFuncSetAttribute(model_kernel<T, S, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed[dev] = smem;
    }
  }
  model_kernel<T, S, M><<<blocks, threads, smem, st>>>(u, v, u_old, fields, out, dt, q, tp);
  return (int)cudaGetLastError();
}

template <typename T, typename M>
int launch_typed(bool jvp, const void* u, const void* second, const void* fields, void* out,
                 double dt, const double* params, const TilePlan& tp, int blocks,
                 int threads, cudaStream_t st) {
  auto uu = static_cast<const T*>(u);
  auto ss = static_cast<const T*>(second);
  auto ff = static_cast<const T*>(fields);
  auto oo = static_cast<T*>(out);
  const ModelParams<T> q = params_from<T>(params);
  return jvp ? launch_one<T, Dual<T>, M>(uu, ss, nullptr, ff, oo, T(dt), q, tp, blocks,
                                         threads, st)
             : launch_one<T, T, M>(uu, nullptr, ss, ff, oo, T(dt), q, tp, blocks, threads,
                                   st);
}

// Launch model M's residual (jvp = false: `second` is u_old) or JVP
// (jvp = true: `second` is v) in the dtype of `dtype`, tiled (ty, tz, lx).
template <typename M>
int launch_model(bool jvp, int dtype, const void* u, const void* second,
                 const void* fields, void* out, double dt, const double* params,
                 int dim, int n0, int n1, int n2, int ty, int tz, int lx, void* stream) {
  const Dims d = make_dims(dim, n0, n1, n2);
  if ((dim != 2 && dim != 3) || d.n < 1 || d.n >= (1L << 31) || ty < 1 || tz < 1 ||
      lx < 1 || ty * tz > kModelThreads || (dim == 2 && ty != 1))
    return (int)cudaErrorInvalidValue;
  TilePlan tp;
  tp.n = (unsigned)d.n;
  tp.dim = dim;
  tp.e0 = n0;
  tp.e1 = dim == 3 ? n1 : 1;
  tp.e2 = dim == 3 ? n2 : n1;
  tp.ty = ty;
  tp.tz = tz;
  tp.lx = lx;
  tp.tiles_y = (tp.e1 + ty - 1) / ty;
  tp.tiles_z = (tp.e2 + tz - 1) / tz;
  const long blocks = (long)tp.tiles_y * tp.tiles_z * ((tp.e0 + lx - 1) / lx);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((ty * tz + 31) / 32);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_typed<float, M>(jvp, u, second, fields, out, dt, params, tp,
                                             (int)blocks, threads, st)
                    : launch_typed<double, M>(jvp, u, second, fields, out, dt, params, tp,
                                              (int)blocks, threads, st);
}

}  // namespace tp

extern "C" {

// dtype: 0 = float32, 1 = float64.  params: tp::kNumParams host doubles in
// ModelParams field order.  Residual entries take (u, u_old), JVP entries
// (u, v); both write (nc, n) to out.  ty, tz, lx: the in-plane tile and the
// planes per block (ty * tz <= 256 threads; ty = 1 in 2D).

int tp_twophase_residual(int dtype, const void* u, const void* u_old,
                         const void* fields, void* out, double dt,
                         const double* params, int dim, int n0, int n1, int n2,
                         int ty, int tz, int lx, void* stream) {
  return tp::launch_model<tp::TwoPhase>(false, dtype, u, u_old, fields, out, dt,
                                        params, dim, n0, n1, n2, ty, tz, lx, stream);
}

int tp_singlephase_residual(int dtype, const void* u, const void* u_old,
                            const void* fields, void* out, double dt,
                            const double* params, int dim, int n0, int n1, int n2,
                            int ty, int tz, int lx, void* stream) {
  return tp::launch_model<tp::SinglePhase>(false, dtype, u, u_old, fields, out, dt,
                                           params, dim, n0, n1, n2, ty, tz, lx, stream);
}

int tp_twophase_jvp(int dtype, const void* u, const void* v, const void* fields,
                    void* out, double dt, const double* params, int dim, int n0,
                    int n1, int n2, int ty, int tz, int lx, void* stream) {
  return tp::launch_model<tp::TwoPhase>(true, dtype, u, v, fields, out, dt, params,
                                        dim, n0, n1, n2, ty, tz, lx, stream);
}

int tp_singlephase_jvp(int dtype, const void* u, const void* v, const void* fields,
                       void* out, double dt, const double* params, int dim, int n0,
                       int n1, int n2, int ty, int tz, int lx, void* stream) {
  return tp::launch_model<tp::SinglePhase>(true, dtype, u, v, fields, out, dt,
                                           params, dim, n0, n1, n2, ty, tz, lx, stream);
}

}  // extern "C"
