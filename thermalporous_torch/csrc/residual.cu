// Fused backward-Euler residual of the two-phase (p, T, S_w) model.
//
// Replaces thermalporous_tpu/kernels/residual_pallas.py:fused_residual
// (185-193; kernel body 121-154), which runs the model's jnp residual on
// VMEM tiles.  Here the physics is inlined: the correlations of
// physics/props.py and physics/relperm.py, the cell terms and well sources
// of models/twophase.py (44-96) and its face fluxes (110-146).
//
// What bounds it on the H100: bytes.  Per cell it reads 2*3 state values
// and 2*dim+7 field values and writes 3 results, about 60 B in f32 for 2D,
// against some 200 flops and 10 transcendentals (exp10/exp per face side)
// -- near the machine balance, but the plain PyTorch version is ~40
// elementwise passes over device memory, so one pass is what matters.
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
//     does, so its flux is an exact zero.
// The order of operations follows the plain PyTorch version
// (thermalporous_torch/models/twophase.py) term by term; built with
// --fmad=false, f64 results then differ from it only through exp10/exp
// (CUDA's are within 1-2 ulp of the CPU libm).

#include "common.cuh"

namespace tp {

// Constants of PhysicalParams / CoreyRelPerm / Grid in the working dtype
// (rounded once from the host's doubles, as the plain version rounds them).
template <typename T>
struct TwoPhaseParams {
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
TwoPhaseParams<T> params_from(const double* h) {
  static_assert(sizeof(TwoPhaseParams<T>) == kNumParams * sizeof(T),
                "TwoPhaseParams must be kNumParams packed scalars");
  TwoPhaseParams<T> q;
  T* f = reinterpret_cast<T*>(&q);
  for (int i = 0; i < kNumParams; ++i) f[i] = T(h[i]);
  return q;
}

__device__ __forceinline__ float exp10_(float x) { return exp10f(x); }
__device__ __forceinline__ double exp10_(double x) { return exp10(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) { return pow(x, y); }

template <typename T>
struct Props {
  TwoPhaseParams<T> q;

  __device__ T rho_w(T p, T t) const {
    return q.rho_w_ref * (T(1) + q.c_w * (p - q.p_ref) - q.beta_w * (t - q.T_ref));
  }
  __device__ T rho_o(T p, T t) const {
    return q.rho_o_ref * (T(1) + q.c_o * (p - q.p_ref) - q.beta_o * (t - q.T_ref));
  }
  // 2.414e-5 * 10 ** (247.8 / (T - 140))
  __device__ T mu_w(T t) const {
    return q.mu_w_coef * exp10_(q.mu_w_num / (t - q.mu_w_shift));
  }
  __device__ T mu_o(T t) const {
    return q.mu_o_ref * exp_(q.b_o * (T(1) / t - q.inv_T_mu_ref));
  }
  __device__ T ipow(T x, T n) const { return n == T(2) ? x * x : pow_(x, n); }
  __device__ T se(T s) const {
    T e = (s - q.s_wr) / q.se_denom;
    return e < T(0) ? T(0) : (e > T(1) ? T(1) : e);
  }
  __device__ T krw(T s) const { return q.k_rw_end * ipow(se(s), q.n_w); }
  __device__ T kro(T s) const { return q.k_ro_end * ipow(T(1) - se(s), q.n_o); }
  __device__ T energy(T p, T t, T s, T phi) const {
    const T fluid = s * rho_w(p, t) * q.cp_w + (T(1) - s) * rho_o(p, t) * q.cp_o;
    return (T(1) - phi) * q.rho_c_rock * t + phi * fluid * t;
  }
};

// Fluxes (water, energy, oil) through the face L -> R along one axis.
template <typename T>
__device__ __forceinline__ void face_flux(const Props<T>& pr, T ddepth,
                                          T pl, T tl, T sl, T pr_, T tr, T sr,
                                          T tgeo, T tcond, T f[3]) {
  const auto& q = pr.q;
  const T rwl = pr.rho_w(pl, tl), rwr = pr.rho_w(pr_, tr);
  const T rol = pr.rho_o(pl, tl), ror = pr.rho_o(pr_, tr);
  const T dphi_w = pl - pr_ - T(0.5) * (rwl + rwr) * q.gravity * ddepth;
  const bool up_w = dphi_w >= T(0);
  const T lam_w = up_w ? rwl * pr.krw(sl) / pr.mu_w(tl) : rwr * pr.krw(sr) / pr.mu_w(tr);
  const T f_w = tgeo * lam_w * dphi_w;
  const T dphi_o = pl - pr_ - T(0.5) * (rol + ror) * q.gravity * ddepth;
  const bool up_o = dphi_o >= T(0);
  const T lam_o = up_o ? rol * pr.kro(sl) / pr.mu_o(tl) : ror * pr.kro(sr) / pr.mu_o(tr);
  const T f_o = tgeo * lam_o * dphi_o;
  const T t_up_w = up_w ? tl : tr;
  const T t_up_o = up_o ? tl : tr;
  f[0] = f_w;
  f[1] = q.cp_w * t_up_w * f_w + q.cp_o * t_up_o * f_o + tcond * (tl - tr);
  f[2] = f_o;
}

// u, u_old: (3, n); fields: (2*dim+7, n) = [tgeo_a.., tcond_a.., phi, wi,
// pbh, tinj, has_tinj, qrate, qheat]; out: (3, n) = (water, energy, oil).
template <typename T>
__global__ void twophase_residual_kernel(const T* __restrict__ u,
                                         const T* __restrict__ u_old,
                                         const T* __restrict__ fields,
                                         T* __restrict__ out, T dt,
                                         TwoPhaseParams<T> q, Dims d) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d.n) return;
  const long n = d.n;
  const int dim = d.dim;
  const Props<T> pr{q};
  int idx[3];
  d.coords(c, idx);

  const T p = u[c], t = u[n + c], s = u[2 * n + c];
  const T p0 = u_old[c], t0 = u_old[n + c], s0 = u_old[2 * n + c];
  const T* wf = fields + (long)(2 * dim + 1) * n;
  const T phi = fields[(long)(2 * dim) * n + c];
  const T wi = wf[c], pbh = wf[n + c], tinj = wf[2 * n + c];
  const T has_tinj = wf[3 * n + c], qrate = wf[4 * n + c], qheat = wf[5 * n + c];

  // accumulation
  const T rho_w = pr.rho_w(p, t), rho_o = pr.rho_o(p, t);
  const T rho_w0 = pr.rho_w(p0, t0), rho_o0 = pr.rho_o(p0, t0);
  const T acc_w = q.vol * phi * (rho_w * s - rho_w0 * s0) / dt;
  const T acc_o = q.vol * phi * (rho_o * (T(1) - s) - rho_o0 * (T(1) - s0)) / dt;
  const T acc_e = q.vol * (pr.energy(p, t, s, phi) - pr.energy(p0, t0, s0, phi)) / dt;

  // Peaceman BHP wells, then rate wells and heaters
  const T dp = pbh - p;
  const bool inflow = dp >= T(0) && has_tinj > T(0.5);
  const T lam_w = rho_w * pr.krw(s) / pr.mu_w(t);
  const T lam_o = rho_o * pr.kro(s) / pr.mu_o(t);
  T q_w, q_o, q_e;
  if (inflow) {
    const T lam_w_inj = pr.rho_w(p, tinj) / pr.mu_w(tinj);
    q_w = wi * dp * lam_w_inj;
    q_o = wi * dp * T(0);
    q_e = q_w * q.cp_w * tinj;
  } else {
    q_w = wi * dp * lam_w;
    q_o = wi * dp * lam_o;
    q_e = (q_w * q.cp_w + q_o * q.cp_o) * t;
  }
  const T t_rate = has_tinj > T(0.5) ? tinj : t;
  const T fw = lam_w / (lam_w + lam_o + T(1e-30));
  if (qrate >= T(0)) {
    q_w = q_w + qrate;
    q_o = q_o + T(0);
    q_e = q_e + qrate * q.cp_w * t_rate;
  } else {
    q_w = q_w + qrate * fw;
    q_o = q_o + qrate * (T(1) - fw);
    q_e = q_e + (qrate * fw * q.cp_w + qrate * (T(1) - fw) * q.cp_o) * t;
  }
  q_e = q_e + qheat;

  T r[3] = {acc_w - q_w, acc_e - q_e, acc_o - q_o};

  // face fluxes: + F(i -> i+1) - F(i-1 -> i) per axis
  for (int a = 0; a < dim; ++a) {
    const long st = d.stride[a];
    const T* tg = fields + (long)a * n;
    const T* tc = fields + (long)(dim + a) * n;
    const long cr = idx[a] + 1 < d.ext[a] ? c + st : c;
    T f[3];
    face_flux(pr, q.ddepth[a], p, t, s, u[cr], u[n + cr], u[2 * n + cr],
              tg[c], tc[c], f);
    r[0] = r[0] + f[0];
    r[1] = r[1] + f[1];
    r[2] = r[2] + f[2];
    if (idx[a] > 0) {
      const long cl = c - st;
      face_flux(pr, q.ddepth[a], u[cl], u[n + cl], u[2 * n + cl], p, t, s,
                tg[cl], tc[cl], f);
      r[0] = r[0] - f[0];
      r[1] = r[1] - f[1];
      r[2] = r[2] - f[2];
    }
  }
  out[c] = r[0];
  out[n + c] = r[1];
  out[2 * n + c] = r[2];
}

}  // namespace tp

extern "C" {

// dtype: 0 = float32, 1 = float64.  params: tp::kNumParams host doubles in
// TwoPhaseParams field order.
int tp_twophase_residual(int dtype, const void* u, const void* u_old,
                         const void* fields, void* out, double dt,
                         const double* params, int dim, int n0, int n1, int n2,
                         void* stream) {
  const tp::Dims d = tp::make_dims(dim, n0, n1, n2);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = tp::blocks_for(d.n);
  if (dtype == 0)
    tp::twophase_residual_kernel<float><<<g, tp::kThreads, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(u_old),
        static_cast<const float*>(fields), static_cast<float*>(out), float(dt),
        tp::params_from<float>(params), d);
  else
    tp::twophase_residual_kernel<double><<<g, tp::kThreads, 0, st>>>(
        static_cast<const double*>(u), static_cast<const double*>(u_old),
        static_cast<const double*>(fields), static_cast<double*>(out), dt,
        tp::params_from<double>(params), d);
  return (int)cudaGetLastError();
}

}  // extern "C"
