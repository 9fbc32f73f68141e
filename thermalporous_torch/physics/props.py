"""Fluid and rock property correlations (counterpart of
``thermalporous_tpu/physics/props.py``).

The coefficients are the reference package's placeholders, copied exactly:
parity is with that package.  The same correlations are inlined in the
residual and JVP kernels (``csrc/residual.cu``), which receive these fields
through :func:`thermalporous_torch.kernels.residual.twophase_params` and
``singlephase_params``.

Units: SI throughout (Pa, K, kg, m, s, W).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhysicalParams:
    """Constants and correlations for water, dead oil and rock."""

    # --- reference conditions -------------------------------------------
    p_ref: float = 1.0e5          # [Pa] reference pressure for densities
    T_ref: float = 288.15         # [K] reference temperature (15 °C)
    T_inj: float = 420.0          # [K] default injection temperature
    T_init: float = 300.0         # [K] default initial reservoir temperature
    p_init: float = 2.0e7         # [Pa] default initial reservoir pressure

    # --- water -----------------------------------------------------------
    rho_w_ref: float = 1000.0     # [kg/m³] at (p_ref, T_ref)
    c_w: float = 4.5e-10          # [1/Pa] water compressibility
    beta_w: float = 4.0e-4        # [1/K] water thermal expansion
    cp_w: float = 4184.0          # [J/kg/K] water specific heat

    # --- dead oil (heavy) --------------------------------------------------
    rho_o_ref: float = 900.0      # [kg/m³] at (p_ref, T_ref)
    c_o: float = 1.0e-9           # [1/Pa] oil compressibility
    beta_o: float = 9.0e-4        # [1/K] oil thermal expansion
    cp_o: float = 2093.0          # [J/kg/K] oil specific heat
    mu_o_ref: float = 1.0         # [Pa·s] oil viscosity at T_mu_ref
    T_mu_ref: float = 293.15      # [K] reference for the Andrade law
    b_o: float = 6360.0           # [K] Andrade activation temperature

    # --- rock --------------------------------------------------------------
    rho_r: float = 2650.0         # [kg/m³] rock grain density
    c_r: float = 920.0            # [J/kg/K] rock specific heat
    kappa_eff: float = 2.5        # [W/m/K] effective thermal conductivity

    # Vogel water viscosity μ_w(T) = MU_W_COEF · 10^(MU_W_NUM / (T − MU_W_SHIFT))
    MU_W_COEF = 2.414e-5
    MU_W_NUM = 247.8
    MU_W_SHIFT = 140.0

    def rho_w(self, p, T):
        """Water density: linearized compressibility + thermal expansion."""
        return self.rho_w_ref * (
            1.0 + self.c_w * (p - self.p_ref) - self.beta_w * (T - self.T_ref)
        )

    def mu_w(self, T):
        """Water viscosity [Pa·s], Vogel correlation (T in Kelvin)."""
        return self.MU_W_COEF * 10.0 ** (self.MU_W_NUM / (T - self.MU_W_SHIFT))

    def rho_o(self, p, T):
        """Dead-oil density: linearized compressibility + thermal expansion."""
        return self.rho_o_ref * (
            1.0 + self.c_o * (p - self.p_ref) - self.beta_o * (T - self.T_ref)
        )

    def mu_o(self, T):
        """Heavy-oil viscosity [Pa·s], Andrade law μ_ref·exp(b·(1/T − 1/T_ref))."""
        return self.mu_o_ref * torch.exp(self.b_o * (1.0 / T - 1.0 / self.T_mu_ref))

    @property
    def rho_c_rock(self) -> float:
        """Volumetric rock heat capacity ρ_r·c_r [J/m³/K]."""
        return self.rho_r * self.c_r

    def energy_density_sp(self, p, T, phi):
        """Single-phase volumetric internal energy (1−φ)ρ_r c_r T + φ ρ c_v T."""
        return (1.0 - phi) * self.rho_c_rock * T + phi * self.rho_w(p, T) * self.cp_w * T

    def energy_density_tp(self, p, T, S, phi):
        """Two-phase volumetric internal energy, water saturation S."""
        fluid = (
            S * self.rho_w(p, T) * self.cp_w
            + (1.0 - S) * self.rho_o(p, T) * self.cp_o
        )
        return (1.0 - phi) * self.rho_c_rock * T + phi * fluid * T
