// Fused backward-Euler residual and its forward derivative (J(u)·v), for the
// two-phase (p, T, S_w) and the single-phase (p, T) model.
//
// Replaces thermalporous_tpu/kernels/residual_pallas.py:
//   tp_twophase_residual, tp_singlephase_residual <- fused_residual (185-193;
//       kernel body 121-154), which runs the model's jnp residual on VMEM
//       tiles;
//   tp_twophase_jvp, tp_singlephase_jvp <- fused_jvp (196-213), the same
//       body under jax.jvp: the Krylov operator of krylov_op="jvp".
// Here the physics is inlined: the correlations of physics/props.py and
// physics/relperm.py, the cell terms and well sources of models/twophase.py
// (38-86) and models/singlephase.py (28-61), and their face fluxes.  The
// device physics is written once, templated on its scalar type S: S = T
// gives the residual, S = Dual<T> (csrc/dual.cuh) gives the residual's
// value and tangent in one pass, of which the JVP kernels write the tangent.
//
// What bounds them on the H100: bytes.  Per cell the residual reads 2*nc
// state values and 2*dim+7 field values and writes nc results (about 88 B
// in f32 for the 3D two-phase model), against some 500 flops with 10
// transcendentals (exp10/exp per face side); the JVP reads u, v and the
// fields (it needs no u_old: the old accumulation is a constant, whose
// tangent is zero) and writes J·v, the same 88 B for about three times the
// arithmetic -- still under the machine balance of ~20 flop/byte.  The
// plain PyTorch versions are tens of elementwise passes over device memory
// (torch.func.jvp about twice as many), so one pass is what matters.
// Design:
//   - one thread per cell, coalesced along the last grid axis; each cell
//     computes its cell terms, then for each axis F(i -> i+1) - F(i-1 -> i),
//     recomputing the left face rather than sharing it with the neighbour:
//     no atomics and no shared-memory exchange, so every run is bitwise
//     reproducible and the face transcendentals cost 2x what a shared face
//     would (cheap next to the bytes);
//   - the physical constants come by value in a struct, the time step by
//     value, so there is no host round trip;
//   - the last slice's face uses the edge-padded phantom neighbour and the
//     zero transmissibility of the full-shape layout, as the plain version
//     does, so its flux and its tangent are exact zeros.
// The order of operations follows the plain PyTorch version term by term,
// and the tangent rules torch's forward-mode formulas (csrc/dual.cuh); built
// with --fmad=false, f64 results then differ from it only through
// exp10/exp (CUDA's are within 1-2 ulp of the CPU libm), which the JVP's
// tangents of mu_w and mu_o inherit from the primal values.

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

  // accumulation minus sources; kOld = false leaves out the old accumulation
  // (a constant: the JVP kernels need only the tangent)
  template <typename T, typename S, bool kOld>
  __device__ static void cell(const Props<T>& pr, const S* x, const T* x0,
                              const CellFields<T>& f, T dt, S* r) {
    const auto& q = pr.q;
    const S p = x[0], t = x[1], s = x[2];
    const S rho_w = pr.rho_w(p, t), rho_o = pr.rho_o(p, t);
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
    const S lam_w = rho_w * pr.krw(s) / pr.mu_w(t);
    const S lam_o = rho_o * pr.kro(s) / pr.mu_o(t);
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

  // fluxes (water, energy, oil) through the face L -> R along one axis
  template <typename T, typename S>
  __device__ static void face(const Props<T>& pr, T ddepth, const S* l, const S* r,
                              T tgeo, T tcond, S* f) {
    const auto& q = pr.q;
    const S rwl = pr.rho_w(l[0], l[1]), rwr = pr.rho_w(r[0], r[1]);
    const S rol = pr.rho_o(l[0], l[1]), ror = pr.rho_o(r[0], r[1]);
    const S dphi_w = l[0] - r[0] - T(0.5) * (rwl + rwr) * q.gravity * ddepth;
    const bool up_w = val(dphi_w) >= T(0);
    const S lam_w = up_w ? rwl * pr.krw(l[2]) / pr.mu_w(l[1])
                         : rwr * pr.krw(r[2]) / pr.mu_w(r[1]);
    const S f_w = tgeo * lam_w * dphi_w;
    const S dphi_o = l[0] - r[0] - T(0.5) * (rol + ror) * q.gravity * ddepth;
    const bool up_o = val(dphi_o) >= T(0);
    const S lam_o = up_o ? rol * pr.kro(l[2]) / pr.mu_o(l[1])
                         : ror * pr.kro(r[2]) / pr.mu_o(r[1]);
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

  template <typename T, typename S, bool kOld>
  __device__ static void cell(const Props<T>& pr, const S* x, const T* x0,
                              const CellFields<T>& f, T dt, S* r) {
    const auto& q = pr.q;
    const S p = x[0], t = x[1];
    T rho0 = T(0), old_e = T(0);
    if constexpr (kOld) {
      rho0 = pr.rho_w(x0[0], x0[1]);
      old_e = pr.energy_sp(x0[0], x0[1], f.phi);
    }
    const S acc_m = q.vol * f.phi * (pr.rho_w(p, t) - rho0) / dt;
    const S acc_e = q.vol * (pr.energy_sp(p, t, f.phi) - old_e) / dt;

    // Peaceman BHP wells, upwinded by the flow's sign: inflow carries the
    // injected fluid at T_inj, outflow the local T
    const S dp = f.pbh - p;
    const bool inflow = val(dp) >= T(0);
    const S t_up = inflow && f.has_tinj > T(0.5) ? S(f.tinj) : t;
    const S lam = pr.rho_w(p, t_up) / pr.mu_w(t_up);
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
    const S rho_l = pr.rho_w(l[0], l[1]), rho_r = pr.rho_w(r[0], r[1]);
    const S dphi = l[0] - r[0] - T(0.5) * (rho_l + rho_r) * q.gravity * ddepth;
    const bool up = val(dphi) >= T(0);
    const S rho_up = up ? rho_l : rho_r;
    const S t_up = up ? l[1] : r[1];
    const S f_m = tgeo * rho_up / pr.mu_w(t_up) * dphi;
    f[0] = f_m;
    f[1] = q.cp_w * t_up * f_m + tcond * (l[1] - r[1]);
  }
};

// The residual (S = T: reads u and u_old, writes R) or its JVP
// (S = Dual<T>: reads u and v, writes J(u) v) of model M, one thread per
// cell.  u, v, u_old, out: (NC, n); fields: (2*dim+7, n) = [tgeo_a..,
// tcond_a.., phi, wi, pbh, tinj, has_tinj, qrate, qheat].
template <typename T, typename S, typename M>
__global__ void model_kernel(const T* __restrict__ u, const T* __restrict__ v,
                             const T* __restrict__ u_old,
                             const T* __restrict__ fields, T* __restrict__ out,
                             T dt, ModelParams<T> q, Dims d) {
  constexpr int NC = M::NC;
  constexpr bool kJvp = is_dual<S>::value;
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  const long n = d.n;
  const int dim = d.dim;
  const Props<T> pr{q};
  int idx[3];
  d.coords(c, idx);

  S x[NC];
  T x0[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    x[i] = load<S>(u, v, i * n + c);
    if constexpr (!kJvp) x0[i] = u_old[i * n + c];
  }
  const T* wf = fields + (long)(2 * dim + 1) * n;
  const CellFields<T> cf{fields[(long)(2 * dim) * n + c], wf[c], wf[n + c],
                         wf[2 * n + c], wf[3 * n + c], wf[4 * n + c], wf[5 * n + c]};
  S r[NC];
  M::template cell<T, S, !kJvp>(pr, x, x0, cf, dt, r);

  // face fluxes: + F(i -> i+1) - F(i-1 -> i) per axis
  for (int a = 0; a < dim; ++a) {
    const long st = d.stride[a];
    const T* tg = fields + (long)a * n;
    const T* tc = fields + (long)(dim + a) * n;
    const long cr = idx[a] + 1 < d.ext[a] ? c + st : c;
    S nb[NC], f[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) nb[i] = load<S>(u, v, i * n + cr);
    M::face(pr, q.ddepth[a], x, nb, tg[c], tc[c], f);
#pragma unroll
    for (int i = 0; i < NC; ++i) r[i] = r[i] + f[i];
    if (idx[a] > 0) {
      const long cl = c - st;
#pragma unroll
      for (int i = 0; i < NC; ++i) nb[i] = load<S>(u, v, i * n + cl);
      M::face(pr, q.ddepth[a], nb, x, tg[cl], tc[cl], f);
#pragma unroll
      for (int i = 0; i < NC; ++i) r[i] = r[i] - f[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) out[i * n + c] = out_part(r[i]);
}

// Launch model M's residual (jvp = false: `second` is u_old) or JVP
// (jvp = true: `second` is v) in the dtype of `dtype`.
template <typename M>
int launch_model(bool jvp, int dtype, const void* u, const void* second,
                 const void* fields, void* out, double dt, const double* params,
                 int dim, int n0, int n1, int n2, void* stream) {
  const Dims d = make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks_for(d.n);
  if (dtype == 0) {
    auto uu = static_cast<const float*>(u);
    auto ss = static_cast<const float*>(second);
    auto ff = static_cast<const float*>(fields);
    auto oo = static_cast<float*>(out);
    if (jvp)
      model_kernel<float, Dual<float>, M><<<g, kThreads, 0, st>>>(
          uu, ss, nullptr, ff, oo, float(dt), params_from<float>(params), d);
    else
      model_kernel<float, float, M><<<g, kThreads, 0, st>>>(
          uu, nullptr, ss, ff, oo, float(dt), params_from<float>(params), d);
  } else {
    auto uu = static_cast<const double*>(u);
    auto ss = static_cast<const double*>(second);
    auto ff = static_cast<const double*>(fields);
    auto oo = static_cast<double*>(out);
    if (jvp)
      model_kernel<double, Dual<double>, M><<<g, kThreads, 0, st>>>(
          uu, ss, nullptr, ff, oo, dt, params_from<double>(params), d);
    else
      model_kernel<double, double, M><<<g, kThreads, 0, st>>>(
          uu, nullptr, ss, ff, oo, dt, params_from<double>(params), d);
  }
  return (int)cudaGetLastError();
}

}  // namespace tp

extern "C" {

// dtype: 0 = float32, 1 = float64.  params: tp::kNumParams host doubles in
// ModelParams field order.  Residual entries take (u, u_old), JVP entries
// (u, v); both write (nc, n) to out.

int tp_twophase_residual(int dtype, const void* u, const void* u_old,
                         const void* fields, void* out, double dt,
                         const double* params, int dim, int n0, int n1, int n2,
                         void* stream) {
  return tp::launch_model<tp::TwoPhase>(false, dtype, u, u_old, fields, out, dt,
                                        params, dim, n0, n1, n2, stream);
}

int tp_singlephase_residual(int dtype, const void* u, const void* u_old,
                            const void* fields, void* out, double dt,
                            const double* params, int dim, int n0, int n1, int n2,
                            void* stream) {
  return tp::launch_model<tp::SinglePhase>(false, dtype, u, u_old, fields, out, dt,
                                           params, dim, n0, n1, n2, stream);
}

int tp_twophase_jvp(int dtype, const void* u, const void* v, const void* fields,
                    void* out, double dt, const double* params, int dim, int n0,
                    int n1, int n2, void* stream) {
  return tp::launch_model<tp::TwoPhase>(true, dtype, u, v, fields, out, dt, params,
                                        dim, n0, n1, n2, stream);
}

int tp_singlephase_jvp(int dtype, const void* u, const void* v, const void* fields,
                       void* out, double dt, const double* params, int dim, int n0,
                       int n1, int n2, void* stream) {
  return tp::launch_model<tp::SinglePhase>(true, dtype, u, v, fields, out, dt,
                                           params, dim, n0, n1, n2, stream);
}

}  // extern "C"
