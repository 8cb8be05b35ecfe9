"""Avatar training CLI (the reference's train.py surface).

Usage:
    python -m instantavatar_torch.cli.train [--config-name SNARF_NGP]
        [group=option] [a.b=v ...] [+device=cpu]

Composes the conf tree, creates the run dir
(outputs/{name}/{experiment}/{subject}), persists the resolved config,
trains with auto-resume, and runs a final validation.
"""
from __future__ import annotations

from ..config.build import build_trainer, check_ported
from ..utils.cli import parse_cli, resolve_device, setup_run


def main(argv: list[str] | None = None):
    """Run the CLI; returns the trainer and the trained state."""
    cfg = parse_cli(argv, default_config="SNARF_NGP")
    device = resolve_device(cfg)
    check_ported(cfg)
    run_dir = setup_run(cfg)
    print(f"[train] run dir: {run_dir}")
    trainer = build_trainer(cfg, workdir=run_dir, device=device)
    state = trainer.fit()
    trainer.validate(state, epoch=trainer.max_epochs)
    return trainer, state


if __name__ == "__main__":
    main()
