"""Single-phase non-isothermal flow model (p, T) (counterpart of
``thermalporous_tpu/models/singlephase.py``).

  mass:   ∂(φρ)/∂t + ∇·(ρu) = q,       u = −(K/μ(T))(∇p − ρ g ∇z)
  energy: ∂((1−φ)ρ_r c_r T + φ ρ c_v T)/∂t + ∇·(ρ c_p T u) − ∇·(κ ∇T) = q_h

Cell-centred TPFA, backward Euler, upwinded mobility and enthalpy, no-flow
boundaries, Peaceman wells and heaters as cell sources.

Unknowns: 0 = p [Pa], 1 = T [K].  Equations: 0 = mass, 1 = energy.

The single-phase kernels of ``csrc/residual.cu`` inline this module's
physics in the same order of operations.
"""

from __future__ import annotations

import torch

from thermalporous_torch._device import reduce_dtype
from thermalporous_torch.models.base import ProblemData, ThermalModelBase
from thermalporous_torch.physics.wells import WellFields


class SinglePhaseModel(ThermalModelBase):
    nc = 2
    eq_labels = ("mass_kg", "energy_J")

    def well_sources(self, u, well: WellFields):
        """Per-cell source terms (nc, *grid), positive INTO the reservoir."""
        pp = self.pp
        p, T = u[0], u[1]

        # Peaceman BHP wells, upwinded by the flow's sign: inflow carries the
        # injected fluid at T_inj, outflow the local T
        dp = well.pbh - p
        inflow = dp >= 0.0
        t_up = torch.where(inflow & (well.has_tinj > 0.5), well.tinj, T)
        lam = pp.rho_w(p, t_up) / pp.mu_w(t_up)
        q_m = well.wi * lam * dp
        q_e = q_m * pp.cp_w * t_up

        # rate wells: a fixed mass rate; injection carries T_inj
        t_rate = torch.where(well.has_tinj > 0.5, well.tinj, T)
        q_m = q_m + well.qrate
        q_e = q_e + well.qrate * pp.cp_w * torch.where(well.qrate >= 0.0, t_rate, T)

        q_e = q_e + well.qheat
        return torch.stack([q_m, q_e])

    def cell_terms(self, u, u_old, dt, phi, well: WellFields):
        pp = self.pp
        vol = self.grid.cell_volume
        p, T = u[0], u[1]
        p0, T0 = u_old[0], u_old[1]
        rho = pp.rho_w(p, T)
        rho0 = pp.rho_w(p0, T0)
        acc_m = vol * phi * (rho - rho0) / dt
        acc_e = vol * (pp.energy_density_sp(p, T, phi)
                       - pp.energy_density_sp(p0, T0, phi)) / dt
        return torch.stack([acc_m, acc_e]) - self.well_sources(u, well)

    def in_place_totals(self, u, data: ProblemData) -> torch.Tensor:
        """(total fluid mass [kg], total thermal energy [J]): the integrals
        of the ``cell_terms`` accumulation densities, summed in f64 when the
        state is f32."""
        pp = self.pp
        vol = self.grid.cell_volume
        p, T = u[0], u[1]
        m = vol * data.phi * pp.rho_w(p, T)
        e = vol * pp.energy_density_sp(p, T, data.phi)
        acc = reduce_dtype(u.dtype)
        return self.cell_sums([m, e], data, acc)

    def face_terms(self, axis, u_l, u_r, tgeo, tcond):
        pp = self.pp
        g = self.grid.gravity
        ddepth = self._ddepth[axis]
        p_l, t_l = u_l[0], u_l[1]
        p_r, t_r = u_r[0], u_r[1]
        rho_l = pp.rho_w(p_l, t_l)
        rho_r = pp.rho_w(p_r, t_r)
        dphi = p_l - p_r - 0.5 * (rho_l + rho_r) * g * ddepth
        up = dphi >= 0.0
        rho_up = torch.where(up, rho_l, rho_r)
        t_up = torch.where(up, t_l, t_r)
        f_m = tgeo * rho_up / pp.mu_w(t_up) * dphi
        f_e = pp.cp_w * t_up * f_m + tcond * (t_l - t_r)
        return torch.stack([f_m, f_e])

    def residual_scales(self, u_old, dt, data: ProblemData):
        pp = self.pp
        vol = self.grid.cell_volume
        w = data.wells
        p0, t0 = u_old[0], u_old[1]
        rho = pp.rho_w(p0, t0)
        mass = vol * data.phi * rho / dt
        energy = vol * ((1.0 - data.phi) * pp.rho_c_rock
                        + data.phi * rho * pp.cp_w) * t0 / dt
        # well cells: normalize by the well's own throughput, which can
        # dwarf the cell content per step
        q_char = (
            w.wi * (rho / pp.mu_w(t0)) * (torch.abs(w.pbh - p0) + 0.01 * torch.abs(p0))
            + torch.abs(w.qrate)
        )
        mass = mass + q_char
        energy = energy + q_char * pp.cp_w * t0 + torch.abs(w.qheat)
        return torch.stack([mass, energy])

    def initial_state(self, data: ProblemData, dtype=None) -> torch.Tensor:
        pp = self.pp
        grid = self.grid
        dtype = dtype or data.fields.dtype
        dev = data.fields.device
        ones = torch.ones(grid.shape, dtype=dtype, device=dev)
        p = pp.p_init * ones
        depths = grid.cell_depths(dtype, dev)
        if depths is not None:
            # hydrostatic equilibrium around the initial temperature
            rho0 = pp.rho_w(pp.p_init, pp.T_init)
            p = p + rho0 * grid.gravity * (depths - depths.reshape(-1)[0])
        t = pp.T_init * ones
        return torch.stack([p, t])
