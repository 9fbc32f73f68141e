"""Named case presets (counterpart of ``thermalporous_tpu/presets.py``).

Each preset returns a :class:`Case`: the model, its problem data on
``device`` in ``dtype``, and the solver and controller configurations the
reference's preset of the same name sets.  Ported: the two-phase presets
``tp_thermal_2d``, ``tp_spe10_3d``, the flagship ``tp_spe10_full`` and
``tp_spe10_padded``.  The single-phase presets wait for the single-phase
model, ``tp_spe10_inner`` for CPTR inner iterations.

Every preset builds on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thermalporous_torch._device import require_cuda
from thermalporous_torch.core.grid import Grid
from thermalporous_torch.data.spe10 import SPE10_SHAPE, SPE10_SPACING_M, synthetic_spe10
from thermalporous_torch.models.base import ProblemData, ThermalModelBase, make_problem_data
from thermalporous_torch.models.twophase import TwoPhaseModel
from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.wells import Well, per_well_masks
from thermalporous_torch.precond.cpr import CPRConfig
from thermalporous_torch.precond.gmg import GMGConfig
from thermalporous_torch.solve.newton import NewtonConfig
from thermalporous_torch.solve.timeloop import Simulator, TimeConfig


@dataclasses.dataclass
class Case:
    name: str
    description: str
    model: ThermalModelBase
    data: ProblemData
    time_cfg: TimeConfig
    newton_cfg: NewtonConfig
    t_end: float
    precond: str = "cptr"
    well_masks: dict | None = None
    pc_cfg: CPRConfig | None = None

    def simulator(self, **overrides) -> Simulator:
        """The case's :class:`Simulator` on its data's device; keyword
        arguments replace the case's configurations (``pc_cfg``,
        ``newton_cfg``, ``time_cfg``)."""
        kw = dict(precond=self.precond, pc_cfg=self.pc_cfg, newton_cfg=self.newton_cfg,
                  time_cfg=self.time_cfg, device=self.data.fields.device)
        kw.update(overrides)
        return Simulator(self.model, self.data, **kw)


def tp_thermal_2d(n: int = 60, *, device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> Case:
    """2D two-phase dead-oil thermal displacement, full CPTR (60×60)."""
    device = require_cuda(device)
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(300.0 / n, 300.0 / n), thickness=10.0)
    rng = np.random.default_rng(11)
    k = 2e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7, name="PROD"),
    ]
    return Case(
        name="tp_thermal_2d",
        description="2D two-phase dead-oil thermal displacement (60x60)",
        model=TwoPhaseModel(g, pp, s_init=0.2),
        data=make_problem_data(g, pp, kx=k, phi=0.2, wells=wells, dtype=dtype,
                               device=device),
        time_cfg=TimeConfig(dt_init=600.0, dt_max=5 * 86400.0),
        newton_cfg=NewtonConfig(ksp_maxiter=32, ksp_ew=True),
        t_end=90 * 86400.0,
        well_masks=per_well_masks(g, wells),
    )


def tp_spe10_3d(nx: int = 60, ny: int = 110, nz: int = 16, seed: int = 2020, *,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> Case:
    """3D two-phase SPE10-subset thermal flood (60×110×16)."""
    device = require_cuda(device)
    pp = PhysicalParams()
    fields = synthetic_spe10(shape=(nx, ny, nz), seed=seed, tarbert_frac=0.5)
    g = Grid(shape=(nx, ny, nz), spacing=SPE10_SPACING_M, gravity=9.81,
             depth_top=3600.0 * 0.3048)
    wells = [
        Well(cells=tuple((nx // 2, ny // 2, iz) for iz in range(nz)),
             control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
        Well(cells=tuple((2, 2, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name="P1"),
        Well(cells=tuple((nx - 3, ny - 3, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name="P2"),
    ]
    return Case(
        name="tp_spe10_3d",
        description=f"3D two-phase SPE10-subset thermal flood ({nx}x{ny}x{nz})",
        model=TwoPhaseModel(g, pp, s_init=0.15),
        data=make_problem_data(g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz,
                               phi=fields.phi, wells=wells, dtype=dtype, device=device),
        time_cfg=TimeConfig(dt_init=300.0, dt_max=2 * 86400.0),
        newton_cfg=NewtonConfig(ksp_maxiter=32, max_iters=20, ksp_ew=True),
        pc_cfg=CPRConfig(gmg=GMGConfig(kcycle_min_cells=4096),
                         gmg_t=GMGConfig(cycle_type="v")),
        t_end=30 * 86400.0,
        well_masks=per_well_masks(g, wells),
    )


def _flagship_wells(nx: int, ny: int, nz: int) -> list[Well]:
    """The flagship's five full-height BHP wells: a hot injector at the
    centre, producers near the four corners."""
    return [
        Well(cells=tuple((nx // 2, ny // 2, iz) for iz in range(nz)),
             control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
    ] + [
        Well(cells=tuple((i, j, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name=f"P_{i}_{j}")
        for i, j in [(2, 2), (nx - 3, 2), (2, ny - 3), (nx - 3, ny - 3)]
    ]


def flagship_configs() -> tuple[TimeConfig, NewtonConfig, CPRConfig]:
    """The flagship's controller, Newton and CPTR configurations: failure
    memory, the Appleyard chop with the nonmonotone line search,
    Eisenstat–Walker forcing over a bf16 basis, CPTR with adaptive
    coarsening, a K-cycle/degree-4 pressure and a V-cycle/degree-2
    temperature hierarchy, and one red-black block Gauss–Seidel sweep as
    stage 2."""
    time_cfg = TimeConfig(dt_init=600.0, dt_max=2 * 86400.0, growth=2.0,
                          grow_below=8, shrink_above=14, fail_frac=0.6,
                          fail_relax=1.05)
    newton_cfg = NewtonConfig(atol=3e-5, ksp_rtol=1e-2, ksp_maxiter=16, max_iters=16,
                              pc_lag="every", ds_max=0.2, ls_mode="nonmonotone",
                              ksp_basis="bf16", ksp_ew=True)
    pc_cfg = CPRConfig(
        stage2="rbgs",
        stage2_cols=True,
        gmg=GMGConfig(cycle_type="k", max_coarse_cells=1024, coarsen="adaptive",
                      degree=4, kcycle_min_cells=8192),
        gmg_t=GMGConfig(cycle_type="v", max_coarse_cells=1024, coarsen="adaptive",
                        degree=2),
    )
    return time_cfg, newton_cfg, pc_cfg


def tp_spe10_full(seed: int = 2020, *, shape: tuple[int, int, int] = SPE10_SHAPE,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> Case:
    """The flagship: full SPE10 size, 60×220×85 = 1.122M cells (3.37M
    unknowns), two-phase thermal with gravity and five full-height BHP
    wells, with the reference's solver preset (:func:`flagship_configs`).

    ``shape`` other than the SPE10 size gives the same configuration on a
    smaller synthetic grid (``synthetic_spe10`` at that shape)."""
    device = require_cuda(device)
    nx, ny, nz = shape
    pp = PhysicalParams()
    fields = synthetic_spe10(shape=tuple(shape), seed=seed)
    g = Grid(shape=(nx, ny, nz), spacing=SPE10_SPACING_M, gravity=9.81,
             depth_top=3600.0 * 0.3048)
    wells = _flagship_wells(nx, ny, nz)
    time_cfg, newton_cfg, pc_cfg = flagship_configs()
    full = tuple(shape) == SPE10_SHAPE
    return Case(
        name="tp_spe10_full",
        description=("FULL SPE10-size two-phase thermal (60x220x85, 3.37M dof)" if full
                     else f"flagship configuration at {nx}x{ny}x{nz}"),
        model=TwoPhaseModel(g, pp, s_init=0.15),
        data=make_problem_data(g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz,
                               phi=fields.phi, wells=wells, dtype=dtype, device=device),
        time_cfg=time_cfg,
        newton_cfg=newton_cfg,
        pc_cfg=pc_cfg,
        t_end=30 * 86400.0,
        well_masks=per_well_masks(g, wells),
    )


def tp_spe10_padded(nz_pad: int = 128, seed: int = 2020, *,
                    device: torch.device | str = "cuda",
                    dtype: torch.dtype = torch.float32) -> Case:
    """The flagship grid padded to ``nz_pad`` z-layers with inert cells
    (k = 0, real porosity); wells perforate the active layers only."""
    nx, ny, nz = SPE10_SHAPE
    if nz_pad < nz:
        raise ValueError(f"nz_pad={nz_pad} < active nz={nz}")
    base = tp_spe10_full(seed=seed, device=device, dtype=dtype)
    if nz_pad == nz:
        return base
    pp = PhysicalParams()
    fields = synthetic_spe10(seed=seed)
    pad = [(0, 0), (0, 0), (0, nz_pad - nz)]
    padk = lambda a: np.pad(np.asarray(a), pad)
    phi_pad = np.pad(np.asarray(fields.phi), pad, constant_values=0.2)
    g = Grid(shape=(nx, ny, nz_pad), spacing=SPE10_SPACING_M, gravity=9.81,
             depth_top=3600.0 * 0.3048)
    wells = _flagship_wells(nx, ny, nz)
    return dataclasses.replace(
        base,
        name=f"tp_spe10_pad{nz_pad}",
        description=(f"flagship z-padded to {nz_pad} inert layers "
                     f"(60x220x{nz_pad}; diagnostic)"),
        model=TwoPhaseModel(g, pp, s_init=0.15),
        data=make_problem_data(g, pp, kx=padk(fields.kx), ky=padk(fields.ky),
                               kz=padk(fields.kz), phi=phi_pad, wells=wells,
                               dtype=dtype, device=device),
        well_masks=per_well_masks(g, wells),
    )


PRESETS = {
    "tp_thermal_2d": tp_thermal_2d,
    "tp_spe10_3d": tp_spe10_3d,
    "tp_spe10_full": tp_spe10_full,
    "tp_spe10_padded": tp_spe10_padded,
}


def get_case(name: str, *, device: torch.device | str = "cuda",
             dtype: torch.dtype = torch.float32, **kwargs) -> Case:
    """The named preset on ``device`` in ``dtype`` (other keywords go to the
    preset function)."""
    if name not in PRESETS:
        raise KeyError(f"unknown case {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](device=device, dtype=dtype, **kwargs)
