"""The comparison that decides ``correct``: every accepted step the window
produced, judged by the plain reference after the window has closed.

Per accepted step (u_prev → u, Δt) of every episode:

- ``res_rms``: the reference's material-balance-scaled RMS residual of u
  over the Newton test's tolerance, max(rtol·‖F(u_prev)‖, atol), as the
  reference works both out; the largest over the steps.  It holds the
  model's residual (accumulation, TPFA fluxes with gravity, the thermal
  terms, the wells and heaters) and the whole solve (Newton, FGMRES, CPTR)
  that produced u.
- ``res_max``: the largest scaled residual of any unknown of any step, in
  the same tolerances: an answer altered in a few cells.
- ``dt_gap``: the largest relative gap between an accepted Δt and the one
  the controller's rules give from the episode's start and the steps'
  Newton counts and retries.
- ``failed``: steps that did not converge after the controller's cut-backs
  or whose state fails the physical gate (finite; T, and S_w for two-phase,
  within the configuration's ``gate``).

The control (``lower_precision``) judges the same states rounded to
bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference.controller import expected_dts


@dataclasses.dataclass
class Episode:
    """One ``Simulator.run`` call of the window: its start and every
    accepted step's (state, Δt, Newton, FGMRES, retries, wall)."""

    u0: torch.Tensor
    t0: float
    dt0: float
    cap0: float | None
    states: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)
    failed: int = 0


def gate_ok(u: torch.Tensor, gate: dict) -> bool:
    """The physical gate (``chip_smoke.py:check_physical``'s pattern): the
    state is finite and within the configuration's bounds."""
    if not bool(torch.isfinite(u).all()):
        return False
    T = u[1]
    if "T_min" in gate and float(T.min()) < gate["T_min"]:
        return False
    if "T_max" in gate and float(T.max()) > gate["T_max"]:
        return False
    if u.shape[0] >= 3:
        S = u[2]
        if float(S.min()) < gate.get("S_min", -math.inf) or \
                float(S.max()) > gate.get("S_max", math.inf):
            return False
    return True


def judge(ref, episodes: list[Episode], cfg: dict, t_end: float,
          lower_precision: bool = False) -> dict:
    """The readings of ``episodes`` (see the module's docstring)."""
    newton = cfg["newton"]
    eps = torch.finfo({"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]).eps
    atol = max(float(newton.get("atol", 0.0)), 50.0 * eps)
    rtol = float(newton.get("rtol", 1e-6))
    out = dict(res_rms=0.0, res_max=0.0, dt_gap=0.0, failed=0, steps=0)

    def prepared(u):
        return u.to(torch.bfloat16).to(u.dtype) if lower_precision else u

    for ep in episodes:
        out["failed"] += ep.failed
        prev = prepared(ep.u0)
        for u, rec in zip(ep.states, ep.records):
            u = prepared(u)
            dt = rec["dt"]
            tol = max(rtol * _rms(ref.scaled(prev, prev, dt)), atol)
            r = ref.scaled(u, prev, dt)
            out["res_rms"] = max(out["res_rms"], _finite(_rms(r) / tol))
            out["res_max"] = max(out["res_max"], _finite(float(r.abs().max()) / tol))
            if not gate_ok(u, cfg.get("gate", {})):
                out["failed"] += 1
            out["steps"] += 1
            prev = u
        want = expected_dts(cfg["time"], ep.t0, ep.dt0, ep.cap0, t_end,
                            [(r["newton"], r["retries"]) for r in ep.records])
        for r, w in zip(ep.records, want):
            out["dt_gap"] = max(out["dt_gap"], _finite(abs(r["dt"] - w) / w))
    return out


def _finite(x: float) -> float:
    """``x``, or infinity where it is not a number: a NaN never passes."""
    return x if math.isfinite(x) else math.inf


def _rms(r: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(r * r)))


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [reading, limit]}) — every reading at or under its
    limit, and at least one step judged."""
    shown = {k: [readings[k], limits[k]] for k in ("res_rms", "res_max", "dt_gap", "failed")}
    return readings["steps"] > 0 and all(v <= lim for v, lim in shown.values()), shown
