"""Preconditioner (``precond/cpr.py``, ``gmg.py``, ``chebyshev.py``): the
CPTR set-up's milliseconds per Newton iteration, from the synchronized
``pc_setup`` spans."""


def read(trace):
    spans, newton = trace["spans"], trace["newton_all"]
    if not newton or "pc_setup" not in spans:
        return None
    return 1e3 * spans["pc_setup"]["seconds"] / newton
