"""Port parity of the dense Newton oracle and the utilities (f64, CPU):
``thermalporous_torch.solve.oracle`` and ``thermalporous_torch.utils``
against ``thermalporous_tpu.solve.oracle`` and ``thermalporous_tpu.utils``.

The oracle runs the 6×6 two-phase and single-phase cases of
``tests/test_newton_cptr.py`` (built in the JAX package and carried into
the port as plain arrays): its states must equal the reference oracle's to
1e-10 of each equation's largest value.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import F64, assert_states_close, carry_model_data, t
from tests.test_newton_cptr import _sp_case, _tp_case
from thermalporous_torch import presets
from thermalporous_torch import utils as tutils
from thermalporous_torch.solve import oracle as toracle
from thermalporous_torch.solve.timeloop import StepRecord
from thermalporous_tpu import utils as jutils
from thermalporous_tpu.solve import oracle as joracle

torch.set_num_threads(1)

ORACLE_RTOL = 1e-10
CASES = {"two_phase": (lambda: _tp_case(n=6), [3600.0, 7200.0]),
         "single_phase": (lambda: _sp_case(n=6), [1800.0, 3600.0])}


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_matches_the_reference(name):
    make, dts = CASES[name]
    jm, jd = make()
    tm, td = carry_model_data(jm, jd)
    ref = joracle.oracle_run(jm, jd, dts)
    got = toracle.oracle_run(tm, td, dts)
    assert len(got) == len(ref) == len(dts)
    for g, r in zip(got, ref):
        assert g.dtype == F64 and g.device.type == "cpu"
        assert_states_close(g, r, ORACLE_RTOL)
    # one step from a given state through dense_newton_step alone
    one = toracle.dense_newton_step(tm, got[0], dts[1], td)
    assert_states_close(one, joracle.dense_newton_step(jm, jnp.asarray(ref[0]), dts[1], jd),
                        ORACLE_RTOL)


def test_oracle_refuses_what_it_cannot_gate():
    """Non-convergence raises in both packages; the port's oracle runs in
    f64 on the CPU only."""
    jm, jd = _tp_case(n=6)
    tm, td = carry_model_data(jm, jd)
    u0 = tm.initial_state(td)
    with pytest.raises(RuntimeError, match="did not converge"):
        joracle.dense_newton_step(jm, jm.initial_state(jd), 3600.0, jd, max_iters=1)
    with pytest.raises(RuntimeError, match="did not converge"):
        toracle.dense_newton_step(tm, u0, 3600.0, td, max_iters=1)
    _, td32 = carry_model_data(jm, jd, dtype=torch.float32)
    with pytest.raises(ValueError, match="f64"):
        toracle.dense_newton_step(tm, u0.float(), 3600.0, td32)


# ------------------------------------------------------------- utilities

def test_finite_checks_on_nests():
    """all_finite / assert_all_finite / finite_guard on tensors and nests:
    the same verdicts and the same leaf index as the reference."""
    good = {"b": [np.ones(3), 2.0], "a": (np.zeros((2, 2)), None)}
    bad = {"b": [np.ones(3), 2.0], "a": (np.array([0.0, np.inf, np.nan]), None)}
    tnest = lambda d: {k: type(v)(t(x) if isinstance(x, np.ndarray) else x for x in v)
                       for k, v in d.items()}
    jnest = lambda d: {k: type(v)(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                  for x in v) for k, v in d.items()}
    assert tutils.all_finite(tnest(good)) and jutils.all_finite(jnest(good))
    assert not tutils.all_finite(tnest(bad)) and not jutils.all_finite(jnest(bad))
    tutils.assert_all_finite(tnest(good))
    msgs = []
    for fn, nest in ((tutils.assert_all_finite, tnest(bad)),
                     (jutils.assert_all_finite, jnest(bad))):
        with pytest.raises(FloatingPointError) as err:
            fn(nest, name="state")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == "state[leaf 0]: 2 non-finite entries"

    @dataclasses.dataclass
    class Pair:
        u: torch.Tensor
        v: torch.Tensor

    step = tutils.finite_guard(lambda x: Pair(x, x / x))
    step(t(np.ones(4)))
    with pytest.raises(FloatingPointError, match=r"\[leaf 1\]: 1 non-finite"):
        step(t(np.array([1.0, 0.0, 2.0])))


def test_timer_and_trace(tmp_path):
    with tutils.Timer("work") as tm:
        torch.ones(100).sum()
    assert tm.name == "work" and tm.seconds >= 0.0
    with tutils.Timer("synced", sync=[t(np.ones(3))]) as tm2:
        pass
    assert tm2.seconds >= 0.0
    case = presets.sp_hot_injection_2d(6, device="cpu", dtype=F64)
    sim = case.simulator()
    with tutils.trace(str(tmp_path / "prof")):
        torch.ones(10) @ torch.ones(10)
        sim.run(case.t_end, max_steps=1)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the program's spans beside it, on the profile's time base
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    (episode,) = [e for e in spans["traceEvents"] if e["name"] == "episode"]
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert any(episode["ts"] <= e["ts"] <= episode["ts"] + episode["dur"] for e in ops)


@pytest.mark.parametrize("shape", [(12,), (3, 4)])
def test_power_iteration_finds_the_dominant_eigenvalue(shape, rng):
    """Start vectors differ (a torch.Generator against jax.random), so the
    parity is the converged dominant eigenvalue magnitude, at 1e-8."""
    size = int(np.prod(shape))
    q, _ = np.linalg.qr(rng.standard_normal((size, size)))
    lam = np.concatenate([[-9.0], np.linspace(0.5, 4.0, size - 1)])
    a = (q * lam) @ q.T
    ja, ta = jnp.asarray(a), t(a)
    jmv = lambda v: (ja @ v.reshape(-1)).reshape(shape)
    tmv = lambda v: (ta @ v.reshape(-1)).reshape(shape)
    ref = float(jutils.power_iteration(jmv, shape, iters=80, seed=3))
    got = tutils.power_iteration(tmv, shape, iters=80, seed=3, device="cpu")
    assert got.dtype == F64 and got.dim() == 0
    assert abs(float(got) - 9.0) <= 1e-8 * 9.0
    assert abs(float(got) - ref) <= 1e-8 * ref
    again = tutils.power_iteration(tmv, shape, iters=80, seed=3, device="cpu")
    assert torch.equal(got, again)          # the generator is seeded, not global


def test_convergence_summary_matches():
    rec = lambda i, nn, k, dt, r: StepRecord(step=i, t=dt * i, dt=dt, newton_iters=nn,
                                            ksp_iters=k, retries=r, residual_norm0=1.0,
                                            residual_norm=1e-7, wall_s=0.1)
    records = [rec(1, 3, 17, 600.0, 0), rec(2, 5, 9, 1200.0, 1), rec(3, 0, 0, 300.0, 2)]
    got = tutils.convergence_summary(records)
    ref = jutils.convergence_summary([types.SimpleNamespace(**r.as_dict()) for r in records])
    assert got == ref and got["total_ksp"] == 26 and got["retries"] == 3
    assert tutils.convergence_summary([]) == {} == jutils.convergence_summary([])
