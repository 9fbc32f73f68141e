"""Corey relative permeabilities (counterpart of
``thermalporous_tpu/physics/relperm.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CoreyRelPerm:
    """k_rw(S) = k_rw_end·Se^n_w,  k_ro(S) = k_ro_end·(1−Se)^n_o,
    Se = clip((S − S_wr) / (1 − S_wr − S_or), 0, 1)."""

    s_wr: float = 0.0
    s_or: float = 0.0
    n_w: float = 2.0
    n_o: float = 2.0
    k_rw_end: float = 1.0
    k_ro_end: float = 1.0

    def effective_saturation(self, s):
        """Se in [0, 1].  Written as maximum-then-minimum (the reference's
        ``jnp.clip``) rather than ``torch.clamp``: the values are the same,
        but at exactly Se = 0 or 1 the tie rule of ``maximum``/``minimum``
        passes half the tangent, as JAX's does, where ``clamp`` passes all
        of it — the two would give different Jacobians there."""
        se = (s - self.s_wr) / (1.0 - self.s_wr - self.s_or)
        return torch.minimum(torch.maximum(se, se.new_zeros(())), se.new_ones(()))

    def krw(self, s):
        return self.k_rw_end * self.effective_saturation(s) ** self.n_w

    def kro(self, s):
        return self.k_ro_end * (1.0 - self.effective_saturation(s)) ** self.n_o
