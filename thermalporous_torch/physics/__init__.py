from thermalporous_torch.physics.props import PhysicalParams
from thermalporous_torch.physics.relperm import CoreyRelPerm
from thermalporous_torch.physics.wells import (
    Heater,
    Well,
    WellFields,
    build_well_fields,
    empty_well_fields,
    peaceman_well_index,
    per_well_masks,
    well_rates,
)

__all__ = [
    "PhysicalParams",
    "CoreyRelPerm",
    "Heater",
    "Well",
    "WellFields",
    "build_well_fields",
    "empty_well_fields",
    "peaceman_well_index",
    "per_well_masks",
    "well_rates",
]
