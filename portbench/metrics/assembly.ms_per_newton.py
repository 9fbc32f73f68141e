"""Assembly (``models/base.py:assemble_stencil``, through ``newton_solve``'s
``assemble``): milliseconds per Newton iteration, from the synchronized
spans."""


def read(trace):
    spans, newton = trace["spans"], trace["newton_all"]
    if not newton or "assembly" not in spans:
        return None
    return 1e3 * spans["assembly"]["seconds"] / newton
