"""End-of-run material and energy balance audit (counterpart of
``thermalporous_tpu/io/balance.py``).

The change of the in-place conserved quantities (fluid mass per phase,
thermal energy) against the cumulative well and heater throughput.  For the
backward-Euler TPFA scheme the two agree up to the Newton tolerance: summed
over all cells the interior fluxes telescope (no-flow boundaries), leaving

    M(u_n) − M(u_{n−1}) = Δt_n · Q(u_n) + Δt_n · Σ_cells R(u_n),

so the relative error measures the drift the solver tolerance lets in.

Usage::

    aud = BalanceAuditor(model, data, u0)
    sim.run(t_end, u0=u0, callback=aud)
    print(format_balance(aud.report()))
"""

from __future__ import annotations

import numpy as np
import torch


class BalanceAuditor:
    """``Simulator.run`` callback accumulating the balance audit.

    Host-loop records get Δt·Q(uₙ) here from the state; blocked records
    (``TimeConfig.block_steps > 1``) carry the per-step source integral the
    block computed (``StepRecord.src_dt``), and the in-place totals refresh
    only at their state-consistent (block-final) records, which is all the
    telescoped closure needs.  A record with neither is counted and marks
    the report incomplete.  The totals and the sources come from one device
    computation and one transfer to the host per call.

    Over a grid decomposition (``data`` and the states a rank's extended
    blocks) both totals sum the owned cells and all-reduce (every rank must
    call), so that every rank's report is the same.
    """

    def __init__(self, model, data, u0):
        self.labels = tuple(getattr(model, "eq_labels",
                                    tuple(f"eq{i}" for i in range(model.nc))))
        self._model = model
        self.set_data(data)
        m0, _ = self._totals(u0)
        self.m0 = m0
        self.m_last = self.m0
        self.cum = np.zeros_like(self.m0)
        self.cum_abs = np.zeros_like(self.m0)
        self.steps = 0
        self.skipped = 0

    def set_data(self, data):
        """Rebind the problem data (``Simulator.run_schedule`` calls this at
        every control-segment boundary, so that the sources are the active
        segment's)."""
        self._data = data

    def _totals(self, u) -> tuple[np.ndarray, np.ndarray]:
        """(in-place totals, source totals) at ``u`` as f64 host arrays."""
        m = self._model.in_place_totals(u, self._data)
        q = self._model.source_totals(u, self._data)
        both = torch.stack([m.to(torch.float64), q.to(torch.float64)]).cpu().numpy()
        return both[0], both[1]

    def __call__(self, step, t, u, rec):
        src = getattr(rec, "src_dt", None)
        consistent = getattr(rec, "state_consistent", True)
        if src is not None:
            # blocked: Δtₙ·Q(uₙ) was integrated by the block (Δt > 0, so
            # |∫| per step is Δt·|Q|, the same cum_abs as below)
            src = np.asarray(src, dtype=np.float64)
            self.cum += src
            self.cum_abs += np.abs(src)
            if consistent:
                self.m_last = self._totals(u)[0]
            self.steps += 1
            return
        if not consistent:
            self.skipped += 1
            return
        self.m_last, q = self._totals(u)
        # implicit Euler: sources integrate as Δt × rate at the NEW state
        self.cum += rec.dt * q
        self.cum_abs += rec.dt * np.abs(q)
        self.steps += 1

    def report(self) -> dict:
        """Per-equation-row closure: Δ(in place) against ∫ sources dt.

        ``rel_error`` is normalized by max(|Δ in place|, cumulative absolute
        throughput), so balanced injection and production (Δ ≈ 0 with a large
        through-flow) stay well conditioned.
        """
        delta = self.m_last - self.m0
        err = delta - self.cum
        denom = np.maximum(np.maximum(np.abs(delta), self.cum_abs), 1e-300)
        rows = {}
        for i, lab in enumerate(self.labels):
            rows[lab] = {
                "delta_in_place": float(delta[i]),
                "cum_source": float(self.cum[i]),
                "abs_error": float(err[i]),
                "rel_error": float(abs(err[i]) / denom[i]),
            }
        return {
            "steps": self.steps,
            "complete": self.skipped == 0,
            "skipped_records": self.skipped,
            "rows": rows,
        }


def format_balance(report: dict) -> str:
    """The closure table the CLI prints at the end of a run."""
    lines = ["# material/energy balance audit "
             f"({report['steps']} steps"
             + ("" if report["complete"]
                else f"; INCOMPLETE — {report['skipped_records']} blocked-"
                     "mode records skipped") + ")"]
    lines.append(f"#   {'row':10s} {'Δ in-place':>14s} {'∫ sources dt':>14s} "
                 f"{'error':>11s} {'rel':>9s}")
    for lab, r in report["rows"].items():
        lines.append(
            f"#   {lab:10s} {r['delta_in_place']:+14.6e} "
            f"{r['cum_source']:+14.6e} {r['abs_error']:+11.3e} "
            f"{r['rel_error']:9.2e}"
        )
    return "\n".join(lines)
