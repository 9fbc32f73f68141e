from thermalporous_torch.precond.chebyshev import (
    block_red_black_gauss_seidel,
    chebyshev,
    gershgorin_lambda_max,
)
from thermalporous_torch.precond.cpr import (
    CPRConfig,
    CPRState,
    cpr_apply,
    cpr_setup,
    make_preconditioner,
    resolve_adaptive_coarsening,
)
from thermalporous_torch.precond.gmg import (
    GMGConfig,
    GMGState,
    galerkin_coarsen,
    gmg_apply,
    gmg_setup,
    plan_coarsening,
)

__all__ = [
    "block_red_black_gauss_seidel",
    "chebyshev",
    "gershgorin_lambda_max",
    "CPRConfig",
    "CPRState",
    "cpr_apply",
    "cpr_setup",
    "make_preconditioner",
    "resolve_adaptive_coarsening",
    "GMGConfig",
    "GMGState",
    "galerkin_coarsen",
    "gmg_apply",
    "gmg_setup",
    "plan_coarsening",
]
