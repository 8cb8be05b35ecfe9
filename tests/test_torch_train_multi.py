"""The port's multi-subject trainer (``instantavatar_torch.cli.train_multi``)
on the CPU, mirroring tests/test_cli_pipeline.py's
``test_cli_train_multi_subject``: two synthetic subjects, the same tiny
overrides, ``+device=cpu``; a checkpoint per subject that
``restore_checkpoint`` reads. Also: the run split over two spawned gloo
ranks (one subject each), and the device rule."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from instantavatar_torch.cli import train_multi
from instantavatar_torch.config import load_config
from instantavatar_torch.config.build import build_trainer
from instantavatar_torch.data import make_synthetic_sequence
from instantavatar_torch.parallel import run_ranks
from instantavatar_torch.train.harness import (latest_checkpoint,
                                               restore_checkpoint)
from instantavatar_torch.utils.cli import repo_root

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402  (no jax)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SUBJECTS = ("subj_a", "subj_b")


def _argv(root, run, subjects=SUBJECTS):
    """tests/test_cli_pipeline.py's train_multi arguments, on the CPU."""
    return [
        "--config-name", "SNARF_NGP",
        f"+subjects={','.join(subjects)}",
        f"dataset.opt.dataroot={root}/${{dataset.subject}}",
        f"run_dir={run}/${{dataset.subject}}",
        "network=voxel_triplane",
        "network.opt.voxel_res=8", "network.opt.voxel_feats=4",
        "network.opt.plane_res=16", "network.opt.plane_feats=4",
        "deformer.opt.resolution=32", "deformer.opt.cano_pose=da_pose",
        "renderer.MAX_SAMPLES=32", "renderer.k_cap=8",
        "renderer.grid_size=16",
        "sampler.num_patch=2", "sampler.patch_size=8",
        "dataset.opt.train.start=0", "dataset.opt.train.end=1",
        "dataset.opt.train.skip=1", "dataset.opt.train.downscale=1",
        "dataset.opt.val.start=0", "dataset.opt.val.end=0",
        "dataset.opt.val.downscale=1",
        "dataset.opt.test.start=0", "dataset.opt.test.end=1",
        "dataset.opt.test.downscale=1",
        "train.max_epochs=2", "+device=cpu",
    ]


@pytest.fixture(scope="module")
def subjects_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi")
    for k, name in enumerate(SUBJECTS):
        make_synthetic_sequence(root / name, n_frames=2, H=32, W=32, seed=k,
                                device="cpu")
    return root


@pytest.fixture(scope="module")
def multi_run(subjects_root):
    run = subjects_root / "out"
    return run, train_multi.main(_argv(subjects_root, run))


def _restore(root, run, subject):
    """The subject's checkpoint restored into a fresh state of a trainer
    built from its config, as the eval and animate CLIs load it."""
    argv = [a for a in _argv(root, run)[2:] if not a.startswith("+subj")]
    cfg = load_config(repo_root() / "confs", "SNARF_NGP",
                      argv + [f"dataset.subject={subject}"])
    trainer = build_trainer(cfg, workdir=run / subject, device="cpu")
    last = latest_checkpoint(run / subject / "checkpoints")
    assert last is not None, subject
    return trainer, restore_checkpoint(last, trainer.init_state(),
                                       trainer.avatar.field)


def test_cli_train_multi_subject(subjects_root, multi_run):
    """Both subjects trained in one process: finite losses, 4 steps each
    (2 frames x 2 epochs), a checkpoint per subject that restores into a
    state of its own config, with the trained parameters."""
    run, out = multi_run
    assert [o["subject"] for o in out] == list(SUBJECTS)
    for o in out:
        assert o["state"].step == 4
        assert np.isfinite(float(o["losses"]["loss"]))
        assert o["checkpoint"].parent == run / o["subject"] / "checkpoints"
        trainer, state = _restore(subjects_root, run, o["subject"])
        assert state.step == 4 and state.opt_state.count == 4
        for p, q in zip(trainer.avatar.field.parameters(),
                        o["avatar"].field.parameters()):
            assert torch.equal(p, q)
        assert torch.equal(state.grid.occupancy, o["state"].grid.occupancy)
    a, b = (list(o["avatar"].field.parameters()) for o in out)
    assert not all(torch.equal(p, q) for p, q in zip(a, b))


def test_train_multi_over_two_ranks(subjects_root, tmp_path):
    """Two spawned gloo ranks, one subject each (each rank checks that it
    holds only its own): each subject's checkpoint restores into a state
    of its config, 4 steps, finite parameters. (The datasets draw their
    patches and backgrounds unseeded, as in JAX, so two runs do not give
    the same bits; tests/test_torch_parallel.py holds subjects stepped
    together exactly equal to subjects stepped alone.)"""
    run_ranks(workers.train_multi_rank, 2, backend="gloo",
              store_dir=tmp_path, args=(_argv(subjects_root, tmp_path),),
              timeout=120.0, threads=1)
    for subject in SUBJECTS:
        trainer, state = _restore(subjects_root, tmp_path, subject)
        assert state.step == 4 and state.opt_state.count == 4
        assert all(bool(torch.isfinite(p).all())
                   for p in trainer.avatar.field.parameters())


def test_train_multi_needs_a_gpu_or_the_cpu_key(subjects_root, monkeypatch,
                                                tmp_path):
    """Without CUDA and without +device=cpu it stops with a message before
    it writes anything; without subjects likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(subjects_root, tmp_path / "run")
            if a != "+device=cpu"]
    with pytest.raises(SystemExit, match=r"\+device=cpu"):
        train_multi.main(argv)
    with pytest.raises(SystemExit, match="subjects"):
        train_multi.main(["--config-name", "SNARF_NGP", "+device=cpu"])
    assert not (tmp_path / "run").exists()
