from thermalporous_torch.solve.adjoint import (
    AdjointResult,
    adjoint_gradients,
    ensemble_adjoint_gradients,
    record_ensemble_trajectory,
    record_trajectory,
)
from thermalporous_torch.solve.fgmres import FGMRESResult, fgmres
from thermalporous_torch.solve.newton import NewtonConfig, NewtonStats, newton_solve
from thermalporous_torch.solve.oracle import dense_newton_step, oracle_run
from thermalporous_torch.solve.timeloop import (
    BlockStats,
    SimResult,
    Simulator,
    StepRecord,
    TimeConfig,
    make_block_step_fn,
    make_step_fn,
)

__all__ = ["AdjointResult", "adjoint_gradients", "ensemble_adjoint_gradients",
           "record_ensemble_trajectory", "record_trajectory",
           "FGMRESResult", "fgmres", "NewtonConfig", "NewtonStats",
           "newton_solve", "dense_newton_step", "oracle_run", "SimResult", "Simulator",
           "StepRecord", "TimeConfig", "BlockStats", "make_block_step_fn", "make_step_fn"]
