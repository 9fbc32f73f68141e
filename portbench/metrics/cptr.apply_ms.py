"""Preconditioner: milliseconds per CPTR apply, from the synchronized
``pc_apply`` spans."""


def read(trace):
    span = trace["spans"].get("pc_apply")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["seconds"] / span["calls"]
