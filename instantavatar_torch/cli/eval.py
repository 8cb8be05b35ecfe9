"""Evaluation CLI with test-time pose refinement (the reference's eval.py
surface).

Usage:
    python -m instantavatar_torch.cli.eval [--config-name SNARF_NGP_refine]
        [overrides as for train] [+device=cpu]

Retargets the train split to the test frame range with the refine flag
(poses from ``poses/anim_nerf_test.npz`` where the sequence has it),
takes the train run's field, grid, canonical bake and normalization from
its latest checkpoint with fresh per-frame SMPL parameters, freezes the
field and refines the SMPL parameters for ``train.max_epochs`` epochs
(checkpoints under ``{run_dir}/refinement``), then renders the test split
to ``{run_dir}/test/{i}.png`` triptychs and writes ``results.txt``.
"""
from __future__ import annotations

from ..config.build import build_trainer, check_ported
from ..utils.cli import (load_trained_state, parse_cli, resolve_device,
                         setup_run)


def main(argv: list[str] | None = None):
    """Run the CLI; returns the refine trainer, the refined state and the
    test metrics."""
    cfg = parse_cli(argv, default_config="SNARF_NGP_refine")
    device = resolve_device(cfg)
    check_ported(cfg)
    # the train split becomes the test range, with the test poses
    test_opt = cfg.dataset.opt.test
    for key in ("start", "end", "skip", "downscale"):
        cfg.dataset.opt.train[key] = test_opt[key]
    cfg.dataset.opt.train["refine"] = True
    cfg.dataset.opt.test["refine"] = True
    run_dir = setup_run(cfg)
    print(f"[eval] run dir: {run_dir}")
    trainer = build_trainer(cfg, workdir=run_dir / "refinement",
                            device=device)
    state = load_trained_state(trainer, run_dir, drop_smpl=True)
    state = trainer.fit(state)
    trainer.workdir = run_dir   # test artifacts land in the run dir
    results = trainer.test(state)
    print(f"[eval] {results}")
    return trainer, state, results


if __name__ == "__main__":
    main()
