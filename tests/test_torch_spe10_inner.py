"""Port parity of the ``tp_spe10_inner`` preset (f64, CPU): [P2]'s
inner-iteration CPTR (two inner FGMRES iterations on the decoupled (p, T)
system per outer preconditioner application) on the flagship problem.

Its fields at full size are compared with the reference preset's in
``tests/test_torch_spe10.py::test_presets_match``.  Here: at a small shape
the preset is the flagship's case with the reference preset's solver
changes, and two controller steps of it through both packages'
``Simulator`` (cut to size as ``tests/test_torch_simulator.py`` cuts the
flagship: 8×14×6, small hierarchies, the working dtype as the Krylov basis)
give the same accepted Δt, Newton and FGMRES counts, and states within
1e-8 of each equation's largest value.
"""

import dataclasses

import numpy as np
import torch

from tests._torch_parity import F64, assert_states_close
from tests.test_torch_simulator import SHAPE, SMALL_GMG, _carry, _jax_case, _record
from thermalporous_torch import presets as tpre
from thermalporous_torch.interop import state_to_numpy
from thermalporous_tpu.precond import CPRConfig as JCPRConfig
from thermalporous_tpu.precond import GMGConfig as JGMGConfig
from thermalporous_tpu.solve import NewtonConfig as JNewtonConfig
from thermalporous_tpu.solve import Simulator as JSimulator
from thermalporous_tpu.solve import TimeConfig as JTimeConfig

torch.set_num_threads(1)

STEPS = 2


def test_small_inner_preset_is_the_flagship_with_inner_iterations():
    got = tpre.get_case("tp_spe10_inner", device="cpu", dtype=F64, shape=SHAPE)
    base = tpre.get_case("tp_spe10_full", device="cpu", dtype=F64, shape=SHAPE)
    assert got.name == "tp_spe10_inner"
    assert got.description == "inner-iteration CPTR configuration at 8x14x6"
    # the reference preset's changes (thermalporous_tpu/presets.py:423-446)
    assert got.pc_cfg == dataclasses.replace(base.pc_cfg, inner_iters=2, gmg_t=None,
                                             stage2_cols=False)
    assert got.pc_cfg.inner_method == "fgmres" and got.pc_cfg.stage2 == "rbgs"
    assert (got.time_cfg, got.newton_cfg, got.t_end) == (base.time_cfg, base.newton_cfg,
                                                         base.t_end)
    assert torch.equal(got.data.fields, base.data.fields)
    assert got.model.grid == base.model.grid and got.model.s_init == base.model.s_init
    full = tpre.CASE_DESCRIPTIONS["tp_spe10_inner"]
    assert full == "FULL SPE10-size, [P2]-faithful inner-iteration CPTR"


def test_inner_preset_runs_as_the_reference():
    """Two controller steps of the preset's configuration in both packages."""
    case = tpre.get_case("tp_spe10_inner", device="cpu", dtype=F64, shape=SHAPE)
    pc = dataclasses.asdict(case.pc_cfg)
    gmg = dict(pc.pop("gmg"), **SMALL_GMG, kcycle_min_cells=64)
    pc.pop("gmg_t")
    jpc = JCPRConfig(**pc, gmg=JGMGConfig(**gmg))
    jnewton = JNewtonConfig(**dict(dataclasses.asdict(case.newton_cfg), ksp_basis="same"))
    jtime = JTimeConfig(**dataclasses.asdict(case.time_cfg))
    assert jpc.inner_iters == 2 and jpc.gmg_t is None and not jpc.stage2_cols

    g, pp, model, data = _jax_case()
    jsim = JSimulator(model, data, "cptr", jpc, jnewton, jtime)
    jres = jsim.run(case.t_end, max_steps=STEPS)
    tcase = _carry(g, pp, model, data, jtime, jnewton, jpc)
    tsim = tcase.simulator()
    tres = tsim.run(tcase.t_end, max_steps=STEPS)

    assert tsim.pc_cfg.gmg.level_factors == jsim.pc_cfg.gmg.level_factors
    assert [_record(r) for r in tres.records] == [_record(r) for r in jres.records]
    assert tres.steps == STEPS and all(r.newton_iters > 0 for r in tres.records)
    assert_states_close(state_to_numpy(tres.u), np.asarray(jres.u), 1e-8)
