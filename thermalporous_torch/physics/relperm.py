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
        se = (s - self.s_wr) / (1.0 - self.s_wr - self.s_or)
        return torch.clamp(se, 0.0, 1.0)

    def krw(self, s):
        return self.k_rw_end * self.effective_saturation(s) ** self.n_w

    def kro(self, s):
        return self.k_ro_end * (1.0 - self.effective_saturation(s)) ** self.n_o
