from .smpl import (SMPLModel, SMPLOutput, lbs, rigid_transform_chain,
                   rodrigues, smpl_forward)
from .toy import SMPL_PARENTS, TOY_JOINTS, toy_smpl_model

__all__ = ["SMPLModel", "SMPLOutput", "lbs", "rigid_transform_chain",
           "rodrigues", "smpl_forward", "toy_smpl_model", "SMPL_PARENTS",
           "TOY_JOINTS"]
