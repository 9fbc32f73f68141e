"""Krylov (``solve/fgmres.py:fgmres``): FGMRES iterations per Newton
iteration of the accepted steps, from their records
(``StepRecord.ksp_iters`` over ``newton_iters``)."""


def read(trace):
    recs = trace["records"]
    newton = sum(r["newton"] for r in recs)
    return sum(r["ksp"] for r in recs) / newton if newton else None
