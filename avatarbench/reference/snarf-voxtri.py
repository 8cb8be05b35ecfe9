"""The plain reference of the ``snarf-voxtri`` configuration: the frozen plain
modules' ``AvatarModel`` at the configuration's widths and knobs (its
field the VoxelTriplaneField with the bf16-operand head)."""
from __future__ import annotations

from avatarbench import build


def make_model(cfg: dict, device, steps_per_epoch: int = 100):
    return build.make_model(build.reference_lib(), cfg, device,
                            steps_per_epoch)
