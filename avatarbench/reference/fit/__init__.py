"""The plain parts of the in-the-wild demo's fit that the frozen plain
modules (``plain/``) do not have: the SMPL nearest-vertex warp, LPIPS with
the VGG16 trunk and its heads, the fit's loss terms, Adam over the field
and the SMPL leaves, and the fit step that puts them together. Each
imports only ``torch``, numpy and the frozen plain modules; each says
where it departs from the upstream code it follows."""
from .lpips import VGGLPIPS
from .losses import fit_loss
from .model import POSE_KEYS, FitModel, FitState
from .optim import FitAdam
from .smpl_warp import SMPLWarp, WarpFrame

__all__ = ["VGGLPIPS", "fit_loss", "FitModel", "FitState", "POSE_KEYS",
           "FitAdam", "SMPLWarp", "WarpFrame"]
