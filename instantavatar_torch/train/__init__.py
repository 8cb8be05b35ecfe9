from .model import (WORLD_AABB, AvatarModel, FlatStream,
                    RenderSession, StepDraws, TrainState)
from .optim import (GroupedAdam, OptimizerSpec, make_optimizer,
                    poly_decay_schedule)

__all__ = ["WORLD_AABB", "AvatarModel", "FlatStream",
           "RenderSession", "StepDraws", "TrainState", "GroupedAdam",
           "OptimizerSpec", "make_optimizer", "poly_decay_schedule"]
