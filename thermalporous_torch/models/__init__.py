from thermalporous_torch.models.base import ProblemData, ThermalModelBase, make_problem_data
from thermalporous_torch.models.singlephase import SinglePhaseModel
from thermalporous_torch.models.twophase import TwoPhaseModel

__all__ = ["ProblemData", "ThermalModelBase", "make_problem_data", "SinglePhaseModel",
           "TwoPhaseModel"]
