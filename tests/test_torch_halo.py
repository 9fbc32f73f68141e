"""Ghost exchange, the stencil kernels on decomposed blocks and the
multi-rank dry run, on 4 gloo ranks on the CPU (a 2×2 mesh).

- The explicit halo residual (``dist/halo.py``) and the residual evaluated
  on each rank's extended block, against the JAX package's global
  ``model.residual`` on the same inputs: the shapes of the reference's
  ``test_halo_residual_matches_global``, to 1e-12 relative.
- The block matvec, scalar matvec, Chebyshev smooth (with both second
  outputs), red-black stage 2 and half-sweep on blocks cut at odd
  boundaries, their vectors extended by exchange, against the plain
  versions on the whole grid: bitwise on the owned cells, the stage 2 in
  the whole grid's colours through its parity offset (and wrong without
  it, where the block's origin has an odd index sum).
- ``dryrun_multichip(4, device="cpu", backend="gloo")``: both of the
  reference's scenarios.

The residual and kernel checks are one spawn of four processes
(``dist/launch.py``), the dry run another; the ranks' functions are in
``tests/_torch_ranks.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

import _torch_ranks as ranks
from _torch_parity import carry_model_data, random_block_parts
from thermalporous_torch.core.stencil import ScalarStencil, invert_blocks
from thermalporous_torch.dist.dryrun import dryrun_multichip
from thermalporous_torch.dist.launch import run_ranks
from thermalporous_torch.precond.chebyshev import gershgorin_lambda_max
from thermalporous_tpu.core import Grid
from thermalporous_tpu.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well


def _halo_cases():
    """The reference test's three cases with the JAX residual of each."""
    cases = []
    for model_cls, shape in [(SinglePhaseModel, (16, 24)), (TwoPhaseModel, (16, 24)),
                             (TwoPhaseModel, (8, 16, 4))]:
        pp = PhysicalParams()
        g = Grid(shape=shape, spacing=tuple(10.0 for _ in shape), thickness=5.0,
                 gravity=9.81 if len(shape) == 3 else 0.0)
        rng = np.random.default_rng(1)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [
            Well(cells=(tuple(0 for _ in shape),), control="bhp", p_bh=3.0e7, T_inj=420.0),
            Well(cells=(tuple(n - 1 for n in shape),), control="bhp", p_bh=1.0e7),
        ]
        data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
        model = model_cls(g, pp)
        u_old = model.initial_state(data)
        u = u_old + 1e5 * jnp.asarray(rng.standard_normal(u_old.shape))
        ref = np.asarray(model.residual(u, u_old, 700.0, data))
        tmodel, tdata = carry_model_data(model, data)
        cases.append((tmodel, tdata, torch.as_tensor(np.asarray(u)),
                      torch.as_tensor(np.asarray(u_old)), 700.0, ref))
    return cases


def test_halo_residual_and_kernel_blocks_match_global():
    rng = np.random.default_rng(5)
    shape = ranks.KERNEL_SHAPE
    diag, ups, los = random_block_parts(rng, shape, 3)
    coef = np.stack([diag] + [m for pair in zip(ups, los) for m in pair])
    sdiag, sups, slos = random_block_parts(rng, shape, 1)
    packed = np.stack([sdiag[0, 0]] + [m[0, 0] for pair in zip(sups, slos) for m in pair])
    st = ScalarStencil(torch.as_tensor(packed).contiguous())
    arrays = dict(coef=coef, packed=packed,
                  dinv=invert_blocks(torch.as_tensor(diag)).numpy(),
                  v=rng.standard_normal((3,) + shape), r=rng.standard_normal((3,) + shape),
                  x1=rng.standard_normal((2,) + shape), b=rng.standard_normal(shape),
                  x=rng.standard_normal(shape),
                  lam=gershgorin_lambda_max(st).numpy())
    arrays = {k: np.array(v, order="C") for k, v in arrays.items()}
    parities, _ = run_ranks(ranks.halo_and_kernels_rank, 4, arrays, _halo_cases())
    # the case holds blocks of both colour offsets
    assert sorted(parities) == [0, 0, 1, 1]


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(4, device="cpu", backend="gloo")
    assert out["run"]["steps"] >= 1 and out["schedule"]["steps"] > out["schedule"]["resumed_at"]
