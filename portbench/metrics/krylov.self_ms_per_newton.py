"""Krylov (``solve/fgmres.py:fgmres``): milliseconds of FGMRES per Newton
iteration (every solve's, retries included) less the preconditioner
applies inside it, from the synchronized spans."""


def read(trace):
    spans, newton = trace["spans"], trace["newton_all"]
    if not newton or "fgmres" not in spans:
        return None
    inner = spans.get("pc_apply_in_fgmres", {"seconds": 0.0})["seconds"]
    return 1e3 * (spans["fgmres"]["seconds"] - inner) / newton
