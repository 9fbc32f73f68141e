from thermalporous_torch.data.spe10 import (
    MD_TO_M2,
    SPE10_SHAPE,
    SPE10_SPACING_M,
    SPE10_TARBERT_LAYERS,
    SPE10Fields,
    load_spe10,
    synthetic_spe10,
)

__all__ = [
    "MD_TO_M2",
    "SPE10_SHAPE",
    "SPE10_SPACING_M",
    "SPE10_TARBERT_LAYERS",
    "SPE10Fields",
    "load_spe10",
    "synthetic_spe10",
]
