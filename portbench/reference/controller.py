"""The Δt controller's rules, from the configuration's ``time`` settings:
the Δt each accepted step of an episode must have taken, given the
episode's start and each step's Newton count and retries.

A step tries min(Δt, dt_max, t_end − t); each failed attempt lowers the
failure-memory cap to fail_frac·Δt (when fail_frac is set) and halves Δt
(``cutback``, not below dt_min).  After an accepted step the cap relaxes by
fail_relax, and the next Δt grows by ``growth`` (capped by dt_max and the
cap) after fewer than grow_below Newton iterations, or is cut back after
more than shrink_above.
"""

from __future__ import annotations

INF = float("inf")


def expected_dts(tc: dict, t0: float, dt0: float, cap0: float | None, t_end: float,
                 steps: list[tuple[int, int]]) -> list[float]:
    """The Δt of each accepted step; ``steps`` is [(newton, retries), ...]."""
    dt_max, dt_min = tc.get("dt_max", 1e7), tc.get("dt_min", 1.0)
    growth, cutback = tc.get("growth", 1.5), tc.get("cutback", 0.5)
    grow_below, shrink_above = tc.get("grow_below", 6), tc.get("shrink_above", 10)
    fail_frac, fail_relax = tc.get("fail_frac"), tc.get("fail_relax", 1.25)
    t, dt = t0, dt0
    cap = INF if cap0 is None else cap0
    out = []
    for newton, retries in steps:
        dt = min(dt, dt_max, t_end - t)
        for _ in range(retries):
            if fail_frac is not None:
                cap = min(cap, dt * fail_frac)
            dt = max(dt * cutback, dt_min)
        out.append(dt)
        t += dt
        if fail_frac is not None and cap != INF:
            cap *= fail_relax
        if newton < grow_below:
            dt = max(min(dt * growth, dt_max, cap), dt_min)
        elif newton > shrink_above:
            dt = max(dt * cutback, dt_min)
    return out
