"""SMPL pose fitting from scratch (the reference's fit.py surface).

Usage:
    python -m instantavatar_torch.cli.fit [--config-name SNARF_NGP_fitting]
        [overrides as for train] [+device=cpu]

Trains the field and the per-frame SMPL parameters together
(``SNARF_NGP_fitting``: version-2 deformer gradients, ``ngp_loss`` with
its depth term), then exports the optimized parameters to
``<dataroot>/poses/train.npz``, where later ``train`` runs pick them up.
The fitting conf's own ``w_lpips: 0.01`` raises until LPIPS is ported;
``model.opt.loss.opt.w_lpips=0`` runs without it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config.build import build_trainer, check_ported
from ..utils.cli import parse_cli, repo_root, resolve_device, setup_run


def main(argv: list[str] | None = None):
    """Run the CLI; returns the trainer, the trained state and the path
    of the exported poses."""
    cfg = parse_cli(argv, default_config="SNARF_NGP_fitting")
    device = resolve_device(cfg)
    check_ported(cfg)
    run_dir = setup_run(cfg)
    print(f"[fit] run dir: {run_dir}")
    trainer = build_trainer(cfg, workdir=run_dir, device=device)
    state = trainer.fit()
    out = repo_root() / Path(cfg.dataset.opt.dataroot) / "poses" / "train.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    arrays = state.smpl.to_arrays()
    np.savez(out, **arrays)
    print(f"[fit] exported optimized SMPL params -> {out} "
          f"({arrays['body_pose'].shape[0]} frames)")
    return trainer, state, out


if __name__ == "__main__":
    main()
