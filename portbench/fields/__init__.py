"""Field recipes: ``make(spec, shape, device) -> dict`` of float64
permeability (``kx``, ``ky``, ``kz`` [m²]) and porosity (``phi``) tensors,
each of shape ``shape``, drawn on ``device`` from ``spec["base_seed"]``
with a ``torch.Generator``.  A recipe is found by the name in a
configuration's ``fields.recipe``."""
