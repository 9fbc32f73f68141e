from thermalporous_torch.core.grid import (
    Grid,
    divergence_add,
    harmonic_face_transmissibility,
    neighbor_plus,
    shift_minus,
    shift_plus,
)
from thermalporous_torch.core.stencil import (
    BlockStencil,
    ScalarStencil,
    apply_blocks,
    invert_blocks,
    multiply_blocks,
)

__all__ = [
    "Grid",
    "BlockStencil",
    "ScalarStencil",
    "apply_blocks",
    "invert_blocks",
    "multiply_blocks",
    "divergence_add",
    "harmonic_face_transmissibility",
    "neighbor_plus",
    "shift_minus",
    "shift_plus",
]
