"""Shared CLI plumbing: Hydra-style argument parsing, the device, run-dir
setup and checkpoint loading for the entry points.

Port of ``instantavatar_tpu/utils/cli.py``. One key is the port's own:
``+device=cuda|cpu`` (default ``cuda``). Without a CUDA device the entry
points stop with a message unless ``+device=cpu`` is given; they never
fall back to the CPU by themselves. On the card they switch TF32 off for
matmuls and cuDNN: the SMPL, skinning-bake and metric paths must stay
fp32.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Any

import torch

from ..config import load_config, to_yaml

__all__ = ["parse_cli", "resolve_device", "select_device", "setup_run",
           "repo_root", "load_trained_state"]


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def parse_cli(argv: list[str] | None = None,
              default_config: str = "SNARF_NGP"):
    """Hydra-compatible CLI: ``--config-name NAME`` + ``key=value``
    overrides, composed from the repository's ``confs/``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name = default_config
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--config-name"):
            if "=" in a:
                config_name = a.split("=", 1)[1]
            else:
                i += 1
                config_name = argv[i]
        elif a.startswith("--config-dir"):
            raise SystemExit("--config-dir is not supported; edit confs/")
        else:
            overrides.append(a)
        i += 1
    return load_config(repo_root() / "confs", config_name, overrides)


def resolve_device(cfg: Any) -> torch.device:
    """The run's device from ``+device`` (default cuda)."""
    return select_device(str(cfg.get("device", "cuda")), "+device")


def select_device(name: str, flag: str) -> torch.device:
    """``cpu`` or the current CUDA device for ``name``; ``flag`` is how the
    caller's command line sets it (``+device`` or ``--device``). Stops
    with a message when ``cuda`` is asked for and there is none."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise SystemExit(f"{flag} must be cuda or cpu, not {name!r}")
    if not torch.cuda.is_available():
        sep = " " if flag.startswith("--") else "="
        raise SystemExit(f"no CUDA device: the entry points run on the GPU; "
                         f"pass {flag}{sep}cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def setup_run(cfg: Any) -> Path:
    """Create the run dir and persist the resolved config (the reference's
    train.py writes config.yaml into its run dir)."""
    run_dir = repo_root() / cfg.get("run_dir", "outputs/run")
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.yaml").write_text(to_yaml(cfg))
    return run_dir


def load_trained_state(trainer, run_dir: Path, *, drop_smpl: bool = False,
                       ckpt_subdir: str = "checkpoints"):
    """Init a fresh state and restore the latest checkpoint into it.

    ``drop_smpl`` (the refine flow): take only the field, grid, canonical
    bake and normalization from the train run (``graft``), keeping the
    fresh state's SMPL parameters (the trainer's split), optimizer and
    step 0."""
    from ..train.harness import graft, latest_checkpoint, restore_checkpoint
    last = latest_checkpoint(Path(run_dir) / ckpt_subdir)
    if last is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/"
                                f"{ckpt_subdir}: train first")
    state = (graft if drop_smpl else restore_checkpoint)(
        last, trainer.init_state(), trainer.avatar.field)
    print(f"[cli] restored {last}")
    return state
