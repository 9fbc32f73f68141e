"""Newton (``solve/newton.py:newton_solve``): iterations per accepted step,
from the steps' records (``StepRecord.newton_iters``)."""


def read(trace):
    recs = trace["records"]
    return sum(r["newton"] for r in recs) / len(recs) if recs else None
