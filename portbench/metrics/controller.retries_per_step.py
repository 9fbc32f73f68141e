"""Controller (``solve/timeloop.py:Simulator.run``): Δt cut-backs per
accepted step, from the steps' records (``StepRecord.retries``) in the
traced run's span window."""


def read(trace):
    recs = trace["records"]
    return sum(r["retries"] for r in recs) / len(recs) if recs else None
