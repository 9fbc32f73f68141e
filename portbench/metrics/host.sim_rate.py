"""Host (the Python loop that dispatches every layer): the simulated seconds
of the accepted steps of a window of whole episodes, run as the end-to-end
window runs them but without its profile, over that window's wall seconds:
the rate a forecaster waits at.  Nothing when the window accepted no step."""


def read(trace):
    h = trace["host"]
    if h["sim_s"] <= 0.0 or h["wall_s"] <= 0.0:
        return None
    return h["sim_s"] / h["wall_s"]
