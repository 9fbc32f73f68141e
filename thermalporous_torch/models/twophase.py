"""Two-phase (dead-oil) non-isothermal flow model (p, T, S_w) (counterpart of
``thermalporous_tpu/models/twophase.py``).

Per phase α ∈ {w, o}: ∂(φ ρ_α S_α)/∂t + ∇·(ρ_α u_α) = q_α with
u_α = −(K k_rα(S)/μ_α(T))(∇p − ρ_α g ∇z), S_w + S_o = 1, no capillary
pressure; energy: ∂((1−φ)ρ_r c_r T + φ Σ_α ρ_α S_α c_α T)/∂t
+ ∇·(Σ_α ρ_α c_α T u_α) − ∇·(κ ∇T) = q_h.  Each phase flux is upwinded by
its own driving force including gravity.

Unknowns: 0 = p [Pa], 1 = T [K], 2 = S_w [-].
Equations: 0 = water mass, 1 = energy, 2 = oil mass.

The fused residual kernel (``csrc/residual.cu``) inlines this module's
physics in the same order of operations.
"""

from __future__ import annotations

import torch

from thermalporous_torch._device import reduce_dtype
from thermalporous_torch.core.grid import Grid
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.relperm import CoreyRelPerm
from thermalporous_torch.physics.wells import WellFields


class TwoPhaseModel(ThermalModelBase):
    nc = 3
    eq_labels = ("water_kg", "energy_J", "oil_kg")

    def __init__(self, grid: Grid, pp: PhysicalParams,
                 relperm: CoreyRelPerm | None = None, s_init: float = 0.2):
        super().__init__(grid, pp)
        self.relperm = relperm or CoreyRelPerm()
        self.s_init = s_init

    def well_sources(self, u, well: WellFields):
        """Per-cell source terms (nc, *grid), positive INTO the reservoir."""
        pp = self.pp
        rp = self.relperm
        p, T, s = u[0], u[1], u[2]
        rho_w, rho_o = pp.rho_w(p, T), pp.rho_o(p, T)

        # Peaceman BHP wells: inflow at a well with T_inj injects water at
        # T_inj; otherwise the phases split by their local mobilities.
        dp = well.pbh - p
        inflow = (dp >= 0.0) & (well.has_tinj > 0.5)
        lam_w_inj = pp.rho_w(p, well.tinj) / pp.mu_w(well.tinj)
        lam_w = rho_w * rp.krw(s) / pp.mu_w(T)
        lam_o = rho_o * rp.kro(s) / pp.mu_o(T)
        q_w = well.wi * dp * torch.where(inflow, lam_w_inj, lam_w)
        q_o = well.wi * dp * torch.where(inflow, 0.0, lam_o)
        q_e = torch.where(
            inflow,
            q_w * pp.cp_w * well.tinj,
            (q_w * pp.cp_w + q_o * pp.cp_o) * T,
        )

        # rate wells: a positive rate injects water at T_inj, a negative one
        # produces both phases split by mass fractional flow
        t_rate = torch.where(well.has_tinj > 0.5, well.tinj, T)
        fw = lam_w / (lam_w + lam_o + 1e-30)
        pos = well.qrate >= 0.0
        q_w = q_w + torch.where(pos, well.qrate, well.qrate * fw)
        q_o = q_o + torch.where(pos, 0.0, well.qrate * (1.0 - fw))
        q_e = q_e + torch.where(
            pos,
            well.qrate * pp.cp_w * t_rate,
            (well.qrate * fw * pp.cp_w + well.qrate * (1.0 - fw) * pp.cp_o) * T,
        )
        q_e = q_e + well.qheat
        return torch.stack([q_w, q_e, q_o])

    def cell_terms(self, u, u_old, dt, phi, well: WellFields):
        pp = self.pp
        vol = self.grid.cell_volume
        p, T, s = u[0], u[1], u[2]
        p0, T0, s0 = u_old[0], u_old[1], u_old[2]
        rho_w, rho_o = pp.rho_w(p, T), pp.rho_o(p, T)
        rho_w0, rho_o0 = pp.rho_w(p0, T0), pp.rho_o(p0, T0)
        acc_w = vol * phi * (rho_w * s - rho_w0 * s0) / dt
        acc_o = vol * phi * (rho_o * (1.0 - s) - rho_o0 * (1.0 - s0)) / dt
        acc_e = vol * (pp.energy_density_tp(p, T, s, phi)
                       - pp.energy_density_tp(p0, T0, s0, phi)) / dt
        return torch.stack([acc_w, acc_e, acc_o]) - self.well_sources(u, well)

    def in_place_totals(self, u, data: ProblemData) -> torch.Tensor:
        """(water mass [kg], thermal energy [J], oil mass [kg]) in the
        equation-row order: the integrals of the ``cell_terms`` accumulation
        densities, summed in f64 when the state is f32."""
        pp = self.pp
        vol = self.grid.cell_volume
        p, T, s = u[0], u[1], u[2]
        w = vol * data.phi * pp.rho_w(p, T) * s
        o = vol * data.phi * pp.rho_o(p, T) * (1.0 - s)
        e = vol * pp.energy_density_tp(p, T, s, data.phi)
        acc = reduce_dtype(u.dtype)
        return self.cell_sums([w, e, o], data, acc)

    def face_terms(self, axis, u_l, u_r, tgeo, tcond):
        pp = self.pp
        rp = self.relperm
        g = self.grid.gravity
        ddepth = self._ddepth[axis]
        p_l, t_l, s_l = u_l[0], u_l[1], u_l[2]
        p_r, t_r, s_r = u_r[0], u_r[1], u_r[2]
        rho_w_l, rho_w_r = pp.rho_w(p_l, t_l), pp.rho_w(p_r, t_r)
        rho_o_l, rho_o_r = pp.rho_o(p_l, t_l), pp.rho_o(p_r, t_r)

        dphi_w = p_l - p_r - 0.5 * (rho_w_l + rho_w_r) * g * ddepth
        up_w = dphi_w >= 0.0
        lam_w_up = torch.where(
            up_w,
            rho_w_l * rp.krw(s_l) / pp.mu_w(t_l),
            rho_w_r * rp.krw(s_r) / pp.mu_w(t_r),
        )
        f_w = tgeo * lam_w_up * dphi_w

        dphi_o = p_l - p_r - 0.5 * (rho_o_l + rho_o_r) * g * ddepth
        up_o = dphi_o >= 0.0
        lam_o_up = torch.where(
            up_o,
            rho_o_l * rp.kro(s_l) / pp.mu_o(t_l),
            rho_o_r * rp.kro(s_r) / pp.mu_o(t_r),
        )
        f_o = tgeo * lam_o_up * dphi_o

        t_up_w = torch.where(up_w, t_l, t_r)
        t_up_o = torch.where(up_o, t_l, t_r)
        f_e = pp.cp_w * t_up_w * f_w + pp.cp_o * t_up_o * f_o + tcond * (t_l - t_r)
        return torch.stack([f_w, f_e, f_o])

    def residual_scales(self, u_old, dt, data: ProblemData):
        pp = self.pp
        rp = self.relperm
        vol = self.grid.cell_volume
        w = data.wells
        p0, t0, s0 = u_old[0], u_old[1], u_old[2]
        rho_w, rho_o = pp.rho_w(p0, t0), pp.rho_o(p0, t0)
        mass_w = vol * data.phi * rho_w / dt
        mass_o = vol * data.phi * rho_o / dt
        cap = (1.0 - data.phi) * pp.rho_c_rock + data.phi * (
            s0 * rho_w * pp.cp_w + (1.0 - s0) * rho_o * pp.cp_o
        )
        energy = vol * cap * t0 / dt
        # well cells: total-throughput scale, with ENDPOINT water mobility
        # (the reference's choice, kept for parity)
        lam_tot = rho_w / pp.mu_w(t0) + rho_o * rp.kro(s0) / pp.mu_o(t0)
        q_char = (
            w.wi * lam_tot * (torch.abs(w.pbh - p0) + 0.01 * torch.abs(p0))
            + torch.abs(w.qrate)
        )
        mass_w = mass_w + q_char
        mass_o = mass_o + q_char
        energy = energy + q_char * pp.cp_w * t0 + torch.abs(w.qheat)
        return torch.stack([mass_w, energy, mass_o])

    def initial_state(self, data: ProblemData, dtype=None) -> torch.Tensor:
        pp = self.pp
        grid = self.grid
        dtype = dtype or data.fields.dtype
        dev = data.fields.device
        ones = torch.ones(grid.shape, dtype=dtype, device=dev)
        p = pp.p_init * ones
        depths = grid.cell_depths(dtype, dev)
        if depths is not None:
            rho0 = pp.rho_o(pp.p_init, pp.T_init)
            p = p + rho0 * grid.gravity * (depths - depths.reshape(-1)[0])
        t = pp.T_init * ones
        s = self.s_init * ones
        return torch.stack([p, t, s])
