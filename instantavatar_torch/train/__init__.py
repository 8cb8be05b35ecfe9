from .model import (WORLD_AABB, AvatarModel, AvatarState, FlatStream,
                    RenderSession)

__all__ = ["WORLD_AABB", "AvatarModel", "AvatarState", "FlatStream",
           "RenderSession"]
