from .model import WORLD_AABB, AvatarModel, FlatStream, StepDraws, TrainState
from .optim import GroupedAdam, OptimizerSpec, make_optimizer

__all__ = ["WORLD_AABB", "AvatarModel", "FlatStream", "StepDraws",
           "TrainState", "GroupedAdam", "OptimizerSpec", "make_optimizer"]
