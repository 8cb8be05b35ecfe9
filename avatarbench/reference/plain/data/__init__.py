from .datasets import FrameDataset
from .samplers import PatchSampler

__all__ = ["FrameDataset", "PatchSampler"]
