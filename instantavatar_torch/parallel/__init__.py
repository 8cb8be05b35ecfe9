"""Multi-device parallelism over ``torch.distributed`` (port of
``instantavatar_tpu/parallel``) and a spawn launcher for ranks on one
host."""
from .data_parallel import (PER_FRAME, DPFrameRenderer, Mesh,
                            dp_render_frame, make_dp_render,
                            make_dp_train_step, make_mesh,
                            make_multi_subject_step, rank_draws,
                            shard_batch, stack_subjects)
from .launch import run_ranks

__all__ = ["PER_FRAME", "DPFrameRenderer", "Mesh", "dp_render_frame",
           "make_dp_render", "make_dp_train_step", "make_mesh",
           "make_multi_subject_step", "rank_draws", "shard_batch",
           "stack_subjects", "run_ranks"]
