from thermalporous_torch.precond.chebyshev import chebyshev, gershgorin_lambda_max
from thermalporous_torch.precond.cpr import (
    CPRConfig,
    CPRState,
    cpr_apply,
    cpr_setup,
    make_preconditioner,
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
    "chebyshev",
    "gershgorin_lambda_max",
    "CPRConfig",
    "CPRState",
    "cpr_apply",
    "cpr_setup",
    "make_preconditioner",
    "GMGConfig",
    "GMGState",
    "galerkin_coarsen",
    "gmg_apply",
    "gmg_setup",
    "plan_coarsening",
]
