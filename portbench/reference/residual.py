"""The plain reference of the two models: the backward-Euler residual of
the single-phase (p, T) and two-phase dead-oil (p, T, S_w) thermal models
on a structured grid, in float64 PyTorch.

It is written from the models' equations (the JAX package's
``models/singlephase.py``, ``models/twophase.py``, ``physics/*`` and
``core/grid.py`` are their statement) and imports nothing of either
package.  From the inputs the benchmark hands to both sides — the fields,
the wells and heaters, the physical constants — it works out again what the
program derives: the TPFA transmissibilities, the Peaceman well indices,
the properties and the material-balance scales of the Newton test.

    R_i = V·(a(u_i) − a(u_old,i))/Δt + Σ_faces F_f − q_i

with upwinded phase mobilities and enthalpies (gravity in the potential),
Fourier conduction, Peaceman BHP wells (an injector's inflow carries water
at T_inj), fixed-rate wells and heaters.  Unknowns (p [Pa], T [K][, S_w]);
equations (mass[, energy], …) in the models' row order: single-phase
(mass, energy), two-phase (water, energy, oil).
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


class Props:
    """The fluid and rock correlations with the configuration's constants."""

    def __init__(self, c: dict):
        self.c = c

    def rho_w(self, p, T):
        c = self.c
        return c["rho_w_ref"] * (1.0 + c["c_w"] * (p - c["p_ref"]) - c["beta_w"] * (T - c["T_ref"]))

    def rho_o(self, p, T):
        c = self.c
        return c["rho_o_ref"] * (1.0 + c["c_o"] * (p - c["p_ref"]) - c["beta_o"] * (T - c["T_ref"]))

    def mu_w(self, T):
        # Vogel: 2.414e-5 · 10^(247.8 / (T − 140))
        return 2.414e-5 * torch.pow(10.0, 247.8 / (T - 140.0))

    def mu_o(self, T):
        # Andrade: μ_ref · exp(b (1/T − 1/T_ref))
        c = self.c
        return c["mu_o_ref"] * torch.exp(c["b_o"] * (1.0 / T - 1.0 / c["T_mu_ref"]))

    @property
    def rock(self):
        return self.c["rho_r"] * self.c["c_r"]


def _corey(relperm: dict):
    swr, sor = relperm.get("s_wr", 0.0), relperm.get("s_or", 0.0)
    nw, no = relperm.get("n_w", 2.0), relperm.get("n_o", 2.0)
    krw_end, kro_end = relperm.get("k_rw_end", 1.0), relperm.get("k_ro_end", 1.0)

    def se(s):
        return torch.clamp((s - swr) / (1.0 - swr - sor), 0.0, 1.0)

    return (lambda s: krw_end * se(s) ** nw), (lambda s: kro_end * (1.0 - se(s)) ** no)


def transmissibility(k: torch.Tensor, axis: int, area: float, delta: float) -> torch.Tensor:
    """Harmonic TPFA transmissibility A·2·k_L·k_R/((k_L + k_R)·Δ) of the
    interior faces along ``axis`` (n − 1 of them), 0 between two
    impermeable cells."""
    n = k.shape[axis]
    kl, kr = k.narrow(axis, 0, n - 1), k.narrow(axis, 1, n - 1)
    den = (kl + kr) * delta
    return torch.where(den > 0, area * 2.0 * kl * kr / torch.where(den > 0, den, 1.0), 0.0)


def peaceman(kx: float, ky: float, dx: float, dy: float, dz: float, rw: float) -> float:
    """2π·√(kx·ky)·Δz / ln(r_e/r_w), r_e = 0.28·√(a·dx² + b·dy²)/(√a + √b),
    a = √(ky/kx), b = √(kx/ky)."""
    a, b = math.sqrt(ky / kx), math.sqrt(kx / ky)
    re = 0.28 * math.sqrt(a * dx * dx + b * dy * dy) / (a ** 0.5 + b ** 0.5)
    return 2.0 * math.pi * math.sqrt(kx * ky) * dz / math.log(re / rw)


class Reference:
    """The residual of one configuration's model, from its inputs.

    ``fields``: kx, ky, kz, phi tensors (any float dtype; promoted to
    float64); ``wells``: dicts with ``cells``, ``control`` ("bhp" or
    "rate"), ``p_bh``, ``rate``, ``T_inj`` (None for a producer),
    ``radius``; ``heaters``: dicts with ``cells`` and ``power``.
    """

    def __init__(self, model: str, shape, spacing, gravity: float, fields: dict,
                 wells: list, heaters: list, physics: dict, relperm: dict,
                 device: torch.device):
        self.model, self.shape = model, tuple(shape)
        self.nc = 3 if model == "two_phase" else 2
        self.dim = len(self.shape)
        sp = list(spacing)
        self.vol = math.prod(sp)
        self.props = Props(physics)
        self.krw, self.kro = _corey(relperm)
        self.gravity = gravity if self.dim == 3 else 0.0
        self.dz = sp[2]
        f = {k: v.to(device=device, dtype=F64) for k, v in fields.items()}
        self.phi = f["phi"]
        ks = [f["kx"], f["ky"], f["kz"]]
        self.tgeo, self.tcond = [], []
        kappa = torch.full(self.shape, float(physics["kappa_eff"]), dtype=F64, device=device)
        for a in range(self.dim):
            area = math.prod(sp[:a] + sp[a + 1:])
            self.tgeo.append(transmissibility(ks[a], a, area, sp[a]))
            self.tcond.append(transmissibility(kappa, a, area, sp[a]))
        # wells and heaters as dense per-cell source fields
        kx_h, ky_h = f["kx"].cpu(), f["ky"].cpu()
        z = lambda: torch.zeros(self.shape, dtype=F64)
        wi, wipbh, tinj, inj, qrate, qheat = z(), z(), z(), z(), z(), z()
        for w in wells:
            for c in w["cells"]:
                c = tuple(c)
                if w["control"] == "bhp":
                    idx = peaceman(float(kx_h[c]), float(ky_h[c]), sp[0], sp[1], sp[2],
                                   w["radius"])
                    wi[c] += idx
                    wipbh[c] += idx * w["p_bh"]
                else:
                    qrate[c] += w["rate"] / len(w["cells"])
                if w.get("T_inj") is not None:
                    tinj[c], inj[c] = w["T_inj"], 1.0
        for h in heaters:
            for c in h["cells"]:
                qheat[tuple(c)] += h["power"] / len(h["cells"])
        pbh = torch.where(wi > 0, wipbh / torch.where(wi > 0, wi, 1.0), 0.0)
        to = lambda t: t.to(device)
        self.wi, self.pbh, self.tinj = to(wi), to(pbh), to(tinj)
        self.inj, self.qrate, self.qheat = to(inj) > 0.5, to(qrate), to(qheat)

    # -- sources ------------------------------------------------------------
    def sources(self, u):
        P = self.props
        c = P.c
        p, T = u[0], u[1]
        dp = self.pbh - p
        if self.nc == 2:
            t_up = torch.where((dp >= 0) & self.inj, self.tinj, T)
            q_m = self.wi * P.rho_w(p, t_up) / P.mu_w(t_up) * dp
            q_e = q_m * c["cp_w"] * t_up
            t_rate = torch.where(self.inj, self.tinj, T)
            q_m = q_m + self.qrate
            q_e = q_e + self.qrate * c["cp_w"] * torch.where(self.qrate >= 0, t_rate, T)
            return torch.stack([q_m, q_e + self.qheat])
        s = u[2]
        inflow = (dp >= 0) & self.inj
        lam_w = P.rho_w(p, T) * self.krw(s) / P.mu_w(T)
        lam_o = P.rho_o(p, T) * self.kro(s) / P.mu_o(T)
        lam_inj = P.rho_w(p, self.tinj) / P.mu_w(self.tinj)
        q_w = self.wi * dp * torch.where(inflow, lam_inj, lam_w)
        q_o = torch.where(inflow, 0.0, self.wi * dp * lam_o)
        q_e = torch.where(inflow, q_w * c["cp_w"] * self.tinj,
                          (q_w * c["cp_w"] + q_o * c["cp_o"]) * T)
        t_rate = torch.where(self.inj, self.tinj, T)
        fw = lam_w / (lam_w + lam_o + 1e-30)
        pos = self.qrate >= 0
        q_w = q_w + torch.where(pos, self.qrate, self.qrate * fw)
        q_o = q_o + torch.where(pos, 0.0, self.qrate * (1.0 - fw))
        q_e = q_e + torch.where(pos, self.qrate * c["cp_w"] * t_rate,
                                self.qrate * (fw * c["cp_w"] + (1.0 - fw) * c["cp_o"]) * T)
        return torch.stack([q_w, q_e + self.qheat, q_o])

    # -- accumulation --------------------------------------------------------
    def content(self, u):
        """Per-cell content densities times the cell volume, in the equation
        rows' order."""
        P = self.props
        c = P.c
        p, T = u[0], u[1]
        if self.nc == 2:
            rho = P.rho_w(p, T)
            e = (1.0 - self.phi) * P.rock * T + self.phi * rho * c["cp_w"] * T
            return self.vol * torch.stack([self.phi * rho, e])
        s = u[2]
        rw, ro = P.rho_w(p, T), P.rho_o(p, T)
        e = (1.0 - self.phi) * P.rock * T + self.phi * (s * rw * c["cp_w"]
                                                        + (1.0 - s) * ro * c["cp_o"]) * T
        return self.vol * torch.stack([self.phi * rw * s, e, self.phi * ro * (1.0 - s)])

    # -- fluxes --------------------------------------------------------------
    def fluxes(self, axis, ul, ur, tg, tc):
        P = self.props
        c = P.c
        dd = -self.dz * self.gravity if axis == 2 else 0.0   # g·(depth_L − depth_R)
        pl, tl, pr, tr = ul[0], ul[1], ur[0], ur[1]
        if self.nc == 2:
            rl, rr = P.rho_w(pl, tl), P.rho_w(pr, tr)
            dphi = pl - pr - 0.5 * (rl + rr) * dd
            up = dphi >= 0
            t_up = torch.where(up, tl, tr)
            f_m = tg * torch.where(up, rl, rr) / P.mu_w(t_up) * dphi
            return torch.stack([f_m, c["cp_w"] * t_up * f_m + tc * (tl - tr)])
        sl, sr = ul[2], ur[2]
        out = []
        for rho, kr, mu, cp in ((P.rho_w, self.krw, P.mu_w, c["cp_w"]),
                                (P.rho_o, self.kro, P.mu_o, c["cp_o"])):
            rl, rr = rho(pl, tl), rho(pr, tr)
            dphi = pl - pr - 0.5 * (rl + rr) * dd
            up = dphi >= 0
            lam = torch.where(up, rl * kr(sl) / mu(tl), rr * kr(sr) / mu(tr))
            out.append((tg * lam * dphi, cp * torch.where(up, tl, tr)))
        (f_w, h_w), (f_o, h_o) = out
        return torch.stack([f_w, h_w * f_w + h_o * f_o + tc * (tl - tr), f_o])

    def residual(self, u: torch.Tensor, u_old: torch.Tensor, dt: float) -> torch.Tensor:
        u, u_old = u.to(F64), u_old.to(F64)
        res = (self.content(u) - self.content(u_old)) / dt - self.sources(u)
        for a in range(self.dim):
            n = self.shape[a]
            ul, ur = u.narrow(a + 1, 0, n - 1), u.narrow(a + 1, 1, n - 1)
            f = self.fluxes(a, ul, ur, self.tgeo[a], self.tcond[a])
            res.narrow(a + 1, 0, n - 1).add_(f)
            res.narrow(a + 1, 1, n - 1).sub_(f)
        return res

    def scales(self, u_old: torch.Tensor, dt: float) -> torch.Tensor:
        """The material-balance scales of the Newton test: each cell's
        content rate at the step start, and at a well cell its
        characteristic throughput (with the water's end-point mobility)."""
        P = self.props
        c = P.c
        u_old = u_old.to(F64)
        p0, t0 = u_old[0], u_old[1]
        rw = P.rho_w(p0, t0)
        drive = torch.abs(self.pbh - p0) + 0.01 * torch.abs(p0)
        if self.nc == 2:
            mass = self.vol * self.phi * rw / dt
            energy = self.vol * ((1.0 - self.phi) * P.rock + self.phi * rw * c["cp_w"]) * t0 / dt
            q = self.wi * (rw / P.mu_w(t0)) * drive + torch.abs(self.qrate)
            return torch.stack([mass + q, energy + q * c["cp_w"] * t0 + torch.abs(self.qheat)])
        s0 = u_old[2]
        ro = P.rho_o(p0, t0)
        cap = (1.0 - self.phi) * P.rock + self.phi * (s0 * rw * c["cp_w"]
                                                      + (1.0 - s0) * ro * c["cp_o"])
        q = self.wi * (rw / P.mu_w(t0) + ro * self.kro(s0) / P.mu_o(t0)) * drive \
            + torch.abs(self.qrate)
        mass_w = self.vol * self.phi * rw / dt + q
        mass_o = self.vol * self.phi * ro / dt + q
        energy = self.vol * cap * t0 / dt + q * c["cp_w"] * t0 + torch.abs(self.qheat)
        return torch.stack([mass_w, energy, mass_o])

    def scaled(self, u, u_old, dt) -> torch.Tensor:
        """R(u; u_old, Δt) over the scales, per unknown."""
        return self.residual(u, u_old, dt) / self.scales(u_old, dt)
