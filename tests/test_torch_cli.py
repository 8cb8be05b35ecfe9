"""The port's entry points on the CPU (``+device=cpu``) at the sizes of
``tests/test_cli_pipeline.py``: train -> resume (a no-op) -> test ->
animate -> novel_view, eval (refine) and fit through
``instantavatar_torch.cli``; a train run at the confs' default network
(NGP, the default hash grid); the in-the-wild demo's four commands (fit
with the SMPL deformer, train / novel_view / animate with the demo conf's
smpl_init); checkpoint save/restore; the device rule;
the same flow in a subprocess with the JAX side's libraries blocked; and
the slice
test: a JAX state carried into a run directory through
``checkpoint_from_jax_state``, rendered by the port's ``animate`` CLI
against JAX's ``render_frames`` on the same animation batches."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_torch import convert
from instantavatar_torch.cli import animate, novel_view, train
from instantavatar_torch.cli import eval as eval_cli
from instantavatar_torch.cli import fit as fit_cli
from instantavatar_torch.config import load_config
from instantavatar_torch.config.build import build_trainer
from instantavatar_torch.data import make_synthetic_sequence
from instantavatar_torch.train import RenderSession
from instantavatar_torch.train.harness import (restore_checkpoint,
                                               save_checkpoint)
from instantavatar_torch.utils.image_io import read_png

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("yaml", "cv2", "imageio", "tensorboardX", "PIL", "orbax", "jax",
           "instantavatar_tpu")


def _overrides(seq, run):
    """tests/test_cli_pipeline.py's overrides, the port's device key."""
    return [
        f"dataset.opt.dataroot={seq}", f"run_dir={run}",
        "network=voxel_triplane",
        "network.opt.voxel_res=8", "network.opt.voxel_feats=4",
        "network.opt.plane_res=16", "network.opt.plane_feats=4",
        "deformer.opt.resolution=32", "deformer.opt.cano_pose=da_pose",
        "renderer.MAX_SAMPLES=32", "renderer.k_cap=8",
        "renderer.grid_size=16",
        "dataset.opt.train.start=0", "dataset.opt.train.end=2",
        "dataset.opt.train.skip=1", "dataset.opt.train.downscale=1",
        "dataset.opt.val.start=0", "dataset.opt.val.end=0",
        "dataset.opt.val.skip=1", "dataset.opt.val.downscale=1",
        "dataset.opt.test.start=1", "dataset.opt.test.end=2",
        "dataset.opt.test.skip=1", "dataset.opt.test.downscale=1",
        "+device=cpu",
    ]


TRAIN_ARGS = ["--config-name", "SNARF_NGP", "train.max_epochs=4",
              "train.check_val_every_n_epoch=2", "sampler.num_patch=2",
              "sampler.patch_size=16"]


def _pose_npz(path):
    poses = np.zeros((3, 72), np.float32)
    poses[1, 50] = 0.8
    poses[2, 1] = 0.6
    poses[2, 47] = -0.5
    trans = np.tile(np.array([[0, 0, 3.0]], np.float32), (3, 1))
    np.savez(path, poses=poses, trans=trans)
    return path


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    root = tmp_path_factory.mktemp("flow")
    seq = make_synthetic_sequence(root / "seq", n_frames=3, H=48, W=48,
                                  device="cpu")
    run = root / "run"
    trainer, state = train.main(TRAIN_ARGS + _overrides(seq, run))
    return {"root": root, "seq": seq, "run": run, "trainer": trainer,
            "state": state}


def test_cli_train_writes_run_dir(flow):
    run = flow["run"]
    assert (run / "config.yaml").exists()
    assert sorted(p.name for p in (run / "checkpoints").glob("step_*")) \
        == ["step_00000006", "step_00000012"]
    assert list((run / "val").glob("epoch_*.png"))
    assert list((run / "val").glob("cano_pose_*.png"))
    tags = (run / "tensorboard" / "scalars.jsonl").read_text()
    assert '"val/psnr"' in tags and '"val/counter_avg"' in tags
    assert flow["state"].step == 12


def test_cli_train_resume_noop(flow, capsys):
    """Re-running train after completion resumes at max_epochs and takes
    no step."""
    trainer, state = train.main(TRAIN_ARGS
                                + _overrides(flow["seq"], flow["run"]))
    assert "resumed from" in capsys.readouterr().out
    assert state.step == 12 and trainer.avatar.field.voxel.shape[-1] == 4


def test_trainer_test_writes_results(flow):
    res = flow["trainer"].test(flow["state"])
    run = flow["run"]
    assert (run / "test" / "0.png").exists() and (run / "test" / "1.png") \
        .exists()
    assert read_png(run / "test" / "0.png").shape == (48, 144, 3)
    text = (run / "results.txt").read_text()
    lines = dict(line.split(": ", 1) for line in text.splitlines())
    assert np.isfinite(float(lines["psnr"])) and 0 < float(lines["ssim"]) <= 1
    assert lines["lpips"].startswith("SKIPPED (")
    assert res.keys() == {"psnr", "ssim"}


def test_cli_animate_and_novel_view(flow):
    run = flow["run"]
    pose = _pose_npz(flow["root"] / "dance.npz")
    out = animate.main(["--config-name", "SNARF_NGP",
                        f"+pose_sequence={pose}", "+render_downscale=20",
                        *_overrides(flow["seq"], run)])
    assert out["frames"] == 3
    adir = run / "animation"
    for i in range(3):
        png = read_png(adir / f"{i:04d}.png")
        assert png.shape == (54, 54, 4)
    assert (adir / "animation.gif").exists()
    out = novel_view.main(["--config-name", "SNARF_NGP",
                           "+render_downscale=20", "+n_frames=2",
                           *_overrides(flow["seq"], run)])
    assert out["frames"] == 2
    assert (run / "novel_view" / "novel_view.gif").exists()
    assert read_png(run / "novel_view" / "0001.png").shape == (54, 54, 4)


def test_animate_needs_its_pose_file(flow):
    with pytest.raises(SystemExit, match="pose_sequence"):
        animate.main(["--config-name", "SNARF_NGP",
                      f"+pose_sequence={flow['root'] / 'missing.npz'}",
                      *_overrides(flow["seq"], flow["run"])])


def test_odd_image_sizes_raise(flow):
    """1080 // 16 = 67 px has no 2- or 3-pixel blocks: the flat render
    runs on 1-pixel blocks, as JAX renders it without the prepass
    (tests/test_torch_smpl_deformer.py holds a 47 x 49 frame against
    JAX's), and animate writes finite 67 px frames."""
    pose = _pose_npz(flow["root"] / "dance67.npz")
    out = animate.main(["--config-name", "SNARF_NGP",
                        f"+pose_sequence={pose}", "+render_downscale=16",
                        *_overrides(flow["seq"], flow["run"])])
    assert out["frames"] == 3 and out["nonfinite_frames"] == 0
    assert all(0 < c < 1 for c in out["alpha_coverage"])
    assert read_png(flow["run"] / "animation" / "0002.png").shape \
        == (67, 67, 4)


def test_render_session_reuses_the_frame_grid(flow, monkeypatch):
    """render_frame(grid=None) builds the frame's own grid once per (field
    params, betas, body pose, grid kind) within a session: a turntable
    builds one; a new body pose or grid kind builds again; no session,
    no reuse."""
    av = flow["trainer"].avatar
    calls = []
    for name in ("build_test_grid", "build_pose_grid"):
        real = getattr(av, name)
        monkeypatch.setattr(av, name, lambda s, b, _real=real, _name=name:
                            calls.append(_name) or _real(s, b))
    betas = flow["trainer"].dm.trainset.smpl_params["betas"]
    frames = [b for _, _, b in novel_view.turntable_batches(betas, 3, 20)]
    outs = list(av.render_frames(flow["state"], frames,
                                 image_shape=(54, 54)))
    assert calls == ["build_test_grid"] and len(outs) == 3
    sess = RenderSession()
    posed = dict(frames[0], body_pose=frames[0]["body_pose"] + 0.1)
    for b in (frames[0], frames[1], posed):
        av.render_frame(flow["state"], b, image_shape=(54, 54),
                        session=sess)
    monkeypatch.setattr(av, "eval_grid", "smpl_shell")
    av.render_frame(flow["state"], posed, image_shape=(54, 54),
                    session=sess)
    av.render_frame(flow["state"], posed, image_shape=(54, 54))
    assert calls == ["build_test_grid"] * 3 + ["build_pose_grid"] * 2


def test_cli_eval_refine(flow, tmp_path):
    """tests/test_cli_pipeline.py's eval run on a copy of the trained run:
    the refine conf retargets the train split to the test frames, grafts
    the train checkpoint, refines for one epoch and writes ``results.txt``
    and ``test/{i}.png``. The field after refinement is bit-identical to
    the train checkpoint's and holds no Adam state; the SMPL parameters
    moved from the test split's poses."""
    import shutil
    run = tmp_path / "run"
    shutil.copytree(flow["run"], run)
    ck = torch.load(sorted((run / "checkpoints").glob("step_*"))[-1]
                    / "state.pt", weights_only=True)
    trainer, state, res = eval_cli.main(
        ["--config-name", "SNARF_NGP_refine", "train.max_epochs=1",
         "sampler.num_sample=256", "sampler.kernel_size=4",
         *_overrides(flow["seq"], run)])
    results = (run / "results.txt").read_text()
    psnr = float([ln for ln in results.splitlines()
                  if ln.startswith("psnr")][0].split(":")[1])
    assert np.isfinite(psnr) and res.keys() == {"psnr", "ssim"}
    assert (run / "test" / "0.png").exists()
    assert list((run / "refinement" / "checkpoints").glob("step_*"))
    assert len(trainer.dm.trainset) == 2 and state.step == 2
    for k, v in trainer.avatar.field.state_dict().items():
        assert torch.equal(v, ck["field"][k]), k
    assert state.opt_state.field is None
    sp = trainer.dm.trainset.get_smpl_params()
    assert np.abs(state.smpl.transl.detach().numpy() - sp["transl"]).sum() > 0


def test_cli_fit_exports_poses(tmp_path):
    """tests/test_cli_pipeline.py's fit run: two frames, one epoch, the
    fitting conf (version-2 deformer, ngp_loss's LPIPS and depth terms);
    ``poses/train.npz`` holds every frame's parameters and the loss logs
    carry both patch terms."""
    seq = make_synthetic_sequence(tmp_path / "seq", n_frames=2, H=32, W=32,
                                  device="cpu")
    trainer, state, out = fit_cli.main(
        ["--config-name", "SNARF_NGP_fitting", "train.max_epochs=1",
         "train.check_val_every_n_epoch=1", "sampler.num_patch=2",
         "sampler.patch_size=16", *_overrides(seq, tmp_path / "run"),
         "dataset.opt.train.end=1", "dataset.opt.val.end=0",
         "dataset.opt.test.start=0", "dataset.opt.test.end=1"])
    assert out == seq / "poses" / "train.npz" and out.exists()
    data = np.load(out)
    assert data["body_pose"].shape == (2, 69)
    assert data["transl"].shape == (2, 3) and data["betas"].shape == (1, 10)
    assert trainer.avatar.deformer.version == 2
    losses = trainer.last_losses
    assert "loss_depth_reg" in losses and "drift_transl" in losses
    assert "loss_lpips" in losses
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_fit_at_its_conf_lpips_raises(tmp_path):
    """The fitting conf at its defaults (the NGP network at the default
    hash grid, ``w_lpips: 0.01`` with the random VGG trunk, the depth
    term), one epoch of one 48 px frame: it runs and logs a finite LPIPS
    term (before LPIPS was ported this conf raised)."""
    seq = make_synthetic_sequence(tmp_path / "seq", n_frames=2, H=48, W=48,
                                  device="cpu")
    over = [a for a in _overrides(seq, tmp_path / "run")
            if not a.startswith("network")] + ["dataset.opt.train.end=0"]
    trainer, state, out = fit_cli.main(
        ["--config-name", "SNARF_NGP_fitting", "train.max_epochs=1",
         "sampler.num_patch=2", "sampler.patch_size=16", *over])
    av = trainer.avatar
    assert type(av.field).__name__ == "NGPField" and state.step == 1
    assert av.loss_weights["w_lpips"] == 0.01 and av.lpips_fn.net == "vgg"
    assert not av.lpips_fn.numerically_matched
    lp = float(trainer.last_losses["loss_lpips"])
    assert np.isfinite(lp) and lp > 0 and out.exists()


def test_cli_train_at_the_default_network(tmp_path):
    """``train`` with no network override builds the confs' NGPField at
    the default 16 x 2 @ 2^19 hash grid (48 px, 2 frames, 1 epoch): the
    checkpoint holds the table, the validation frame is finite."""
    seq = make_synthetic_sequence(tmp_path / "seq", n_frames=3, H=48, W=48,
                                  device="cpu")
    over = [a for a in _overrides(seq, tmp_path / "run")
            if not a.startswith("network")] + ["dataset.opt.train.end=1"]
    trainer, state = train.main(["--config-name", "SNARF_NGP",
                                 "train.max_epochs=1", "sampler.num_patch=2",
                                 "sampler.patch_size=16", *over])
    field = trainer.avatar.field
    assert type(field).__name__ == "NGPField"
    assert field.table.shape == (16, 2 ** 19, 2) and state.step == 2
    ck = torch.load(sorted((tmp_path / "run" / "checkpoints")
                           .glob("step_*"))[-1] / "state.pt",
                    weights_only=True)
    assert torch.equal(ck["field"]["table"], field.table.detach())
    tags = (tmp_path / "run" / "tensorboard" / "scalars.jsonl").read_text()
    psnr = [float(ln.split('"value": ')[1].split(",")[0])
            for ln in tags.splitlines() if '"val/psnr"' in ln]
    assert psnr and all(np.isfinite(psnr))


def test_checkpoint_round_trip(flow, tmp_path):
    """save -> restore into a fresh state gives the same tensors (field,
    Adam moments and counts, grid, canonical bake, normalization, step)
    and a bit-identical frame."""
    trainer, state = flow["trainer"], flow["state"]
    field = trainer.avatar.field
    saved = {k: v.clone() for k, v in field.state_dict().items()}
    ck = save_checkpoint(tmp_path, state, field, {"psnr": 1.0})
    batch = trainer.dm.valset[0]
    shape = trainer.dm.valset.image_shape
    before = trainer.avatar.render_frame(state, batch, image_shape=shape)
    fresh = trainer.init_state()
    assert not torch.equal(field.voxel, saved["voxel"])
    back = restore_checkpoint(ck, fresh, field)
    for k, v in field.state_dict().items():
        assert torch.equal(v, saved[k]), k
    opt0, opt1 = state.opt_state, back.opt_state
    assert (opt1.count, opt1.notfinite_count) == (opt0.count,
                                                  opt0.notfinite_count)
    for p0, p1 in zip(opt0.field.param_groups[0]["params"],
                      opt1.field.param_groups[0]["params"]):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt0.field.state[p0][k],
                               opt1.field.state[p1][k])
    for name in ("grid", "deformer_cano"):
        for a, b in zip(getattr(state, name), getattr(back, name)):
            assert torch.equal(a, b), name
    assert torch.equal(back.center, state.center) and back.step == state.step
    after = trainer.avatar.render_frame(back, batch, image_shape=shape)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(before[k], after[k]), k


def test_entry_points_need_a_gpu_or_the_cpu_key(flow, monkeypatch, tmp_path):
    """Without CUDA and without +device=cpu the CLI stops with a message
    (a non-zero exit) before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = [a for a in _overrides(flow["seq"], tmp_path / "run")
            if a != "+device=cpu"]
    with pytest.raises(SystemExit, match=r"\+device=cpu"):
        train.main(TRAIN_ARGS + over)
    with pytest.raises(SystemExit, match=r"\+device=cpu"):
        eval_cli.main(["--config-name", "SNARF_NGP_refine", *over])
    with pytest.raises(SystemExit, match=r"\+device=cpu"):
        fit_cli.main(["--config-name", "SNARF_NGP_fitting", *over])
    assert not (tmp_path / "run").exists()


def test_cli_flow_runs_without_the_jax_side_libraries(tmp_path):
    """The whole CPU flow (train, resume, test, animate, novel_view, eval,
    fit) in a fresh interpreter with yaml, cv2, imageio, tensorboardX,
    PIL, orbax and jax (and the JAX package) blocked: the entry path needs
    only torch, numpy and scipy."""
    over = [a.replace("{SEQ}", str(tmp_path / "seq"))
            .replace("{RUN}", str(tmp_path / "run"))
            for a in _overrides("{SEQ}", "{RUN}")]
    code = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
import numpy as np, torch
torch.set_num_threads(2)
from instantavatar_torch.cli import animate, eval, fit, novel_view, train
from instantavatar_torch.data import make_synthetic_sequence
from instantavatar_torch.train import RenderSession
make_synthetic_sequence({str(tmp_path / 'seq')!r}, n_frames=3, H=48, W=48,
                        style="capsule", device="cpu")
over = {over!r}
args = ["--config-name", "SNARF_NGP", "train.max_epochs=2",
        "train.check_val_every_n_epoch=1", "sampler.num_patch=2",
        "sampler.patch_size=16"] + over
trainer, state = train.main(args)
trainer, state = train.main(args)
trainer.test(state)
poses = np.zeros((2, 72), np.float32); poses[1, 50] = 0.8
np.savez({str(tmp_path / 'p.npz')!r}, poses=poses,
         trans=np.tile(np.array([[0, 0, 3.0]], np.float32), (2, 1)))
animate.main(["+pose_sequence={tmp_path / 'p.npz'}", "+render_downscale=20"]
             + over)
novel_view.main(["+render_downscale=20", "+n_frames=2"] + over)
eval.main(["--config-name", "SNARF_NGP_refine", "train.max_epochs=1",
           "sampler.num_sample=256", "sampler.kernel_size=4"] + over)
fit.main(["--config-name", "SNARF_NGP_fitting",
          "train.max_epochs=1", "sampler.num_patch=2", "sampler.patch_size=16"]
         + over + ["run_dir={tmp_path / 'fitrun'}"])
assert all(sys.modules[m] is None for m in {BLOCKED!r})
print("ENTRY PATH OK")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ENTRY PATH OK" in res.stdout and "resumed from" in res.stdout
    run = tmp_path / "run"
    for f in ("results.txt", "animation/animation.gif",
              "novel_view/novel_view.gif", "test/0.png",
              "refinement/checkpoints"):
        assert (run / f).exists(), f
    assert (tmp_path / "seq" / "poses" / "train.npz").exists()


def _jax_animate_module():
    spec = importlib.util.spec_from_file_location("jax_cli_animate",
                                                  REPO / "cli" / "animate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_animate_matches_jax_render_frames(tmp_path):
    """Slice test. A JAX state with content (JAX's build_trainer on the
    same overrides the port's CLI gets, then numpy-seeded field params
    with a sigma bias) goes into a run directory through
    checkpoint_from_jax_state; the port's animate CLI renders it at 54 px
    against JAX's render_frames on the same animation batches (shell
    grid): >= 40 dB rgb PSNR with both quantized to uint8 as the CLIs
    write them, alpha within 2/255 except on at most one 3 x 3 prepass
    block per frame, there within 13/255. Such a block's warp-cache row
    holds a Broyden J_inv estimate that two fp32 runs can end one rank-1
    update apart (tests/test_torch_deformer.py holds J_inv at 0.1);
    measured: 1 block of 3 frames at 9/255, every other pixel within
    1/255."""
    from instantavatar_tpu.config import load_config as jax_load_config
    from instantavatar_tpu.config.build import build_trainer as jax_build
    from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
    seq = make_synthetic_sequence(tmp_path / "seq", n_frames=3, H=48, W=48,
                                  device="cpu")
    run = tmp_path / "run"
    over = _overrides(seq, run)[:-1] + ["+dataset.opt.native=false"]
    jtr = jax_build(jax_load_config(REPO / "confs", "SNARF_NGP", over),
                    workdir=tmp_path / "jax")
    jav = jtr.avatar
    betas = np.asarray(jtr.dm.trainset.smpl_params["betas"])
    state = jax.jit(jav.init)(jax.random.PRNGKey(42), jnp.asarray(betas))
    pnp = convert.seeded_field_params(8, 16, seed=5, voxel_feats=4,
                                      plane_feats=4, sigma_bias=100.0)
    params = VoxelTriplaneParams(**{
        k: (tuple(map(jnp.asarray, v)) if isinstance(v, list)
            else jnp.asarray(v)) for k, v in pnp.items()})
    state = state._replace(params={**state.params, "field": params})

    ptr = build_trainer(load_config(REPO / "confs", "SNARF_NGP", over),
                        workdir=run, device="cpu")
    convert.checkpoint_from_jax_state(jax.tree.map(np.asarray, state),
                                      ptr.avatar.field, ptr.avatar, run)
    pose = _pose_npz(tmp_path / "dance.npz")
    animate.main(["--config-name", "SNARF_NGP", f"+pose_sequence={pose}",
                  "+render_downscale=20", *over, "+device=cpu"])

    jav.eval_grid = "smpl_shell"
    jcli = _jax_animate_module()
    batches = list(jcli.animation_batches(pose, betas, 20))
    outs = jav.render_frames(state, [b for _, _, b in batches],
                             image_shape=(54, 54), payload="u8")
    for i, out in enumerate(outs):
        rgb = np.clip(out["rgb"].reshape(54, 54, 3), 0, 1)
        alpha = np.clip(out["alpha"].reshape(54, 54, 1), 0, 1)
        want = (np.concatenate([rgb, alpha], -1) * 255).astype(np.uint8)
        got = cv2.imread(str(run / "animation" / f"{i:04d}.png"),
                         cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape
        cover = want[..., 3].mean() / 255
        assert 0.05 < cover < 0.9, cover
        mse = np.mean((got[..., :3] / 255.0 - want[..., :3] / 255.0) ** 2)
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) >= 40.0, (i, mse)
        da = np.abs(got[..., 3].astype(int) - want[..., 3].astype(int))
        assert (da > 2).sum() <= 9 and da.max() <= 13, (i, da.max())


def _demo_overrides(seq, run, snarf=True):
    """The demo flow's overrides: the sequence as ``dataset=custom/video``
    (2 train frames, 1 val, 1 test), the run directory, small network,
    renderer and (with ``snarf``, the demo conf's deformer) SNARF
    sizes."""
    return ["deformer.opt.resolution=32"] * snarf + [
            f"dataset.opt.dataroot={seq}", f"run_dir={run}",
            "network=voxel_triplane", "network.opt.voxel_res=8",
            "network.opt.voxel_feats=4", "network.opt.plane_res=16",
            "network.opt.plane_feats=4", "renderer.MAX_SAMPLES=32",
            "renderer.k_cap=8", "renderer.grid_size=16",
            "dataset.opt.train.end=1", "dataset.opt.val.end=0",
            "dataset.opt.test.start=2", "dataset.opt.test.end=2",
            "dataset.opt.test.skip=1", "sampler.num_patch=2",
            "sampler.patch_size=16", "+device=cpu"]


def test_cli_demo_flow(tmp_path):
    """bash/run-neuman-demo.sh on the port, at 48 px on the CPU: ``fit``
    with ``deformer=smpl`` (the nearest-vertex SMPLDeformer, LPIPS and
    depth terms) exports the poses; ``train --config-name demo
    sampler.dilate=8`` trains on them with per-frame smpl_init grids
    (updated every step, the seeded stack held by the 500-step latch);
    ``novel_view`` and ``animate`` render that run."""
    from instantavatar_torch.deformers import SMPLDeformer
    seq = make_synthetic_sequence(tmp_path / "seq", n_frames=3, H=48, W=48,
                                  device="cpu")
    ftr, fstate, poses = fit_cli.main(
        ["--config-name", "SNARF_NGP_fitting", "dataset=custom/video",
         "deformer=smpl", "train.max_epochs=1",
         *_demo_overrides(seq, tmp_path / "fit", snarf=False)])
    assert isinstance(ftr.avatar.deformer, SMPLDeformer)
    assert ftr.avatar.deformer.threshold == 0.05
    losses = {k: float(v) for k, v in ftr.last_losses.items()}
    assert all(np.isfinite(v) for v in losses.values())
    assert "loss_lpips" in losses and "loss_depth_reg" in losses
    fitted = np.load(poses)
    assert fitted["body_pose"].shape == (2, 69) \
        and fitted["betas"].shape == (1, 10)

    over = _demo_overrides(seq, tmp_path / "demo")
    demo = ["--config-name", "demo", "dataset=custom/video"]
    trainer, state = train.main(demo + ["sampler.dilate=8",
                                        "train.max_epochs=1", *over])
    av = trainer.avatar
    assert av.smpl_init and av.grid_update_interval == 1
    assert trainer.dm.trainset.sampler.dilate == 8
    np.testing.assert_array_equal(trainer.dm.trainset.smpl_params["body_pose"],
                                  fitted["body_pose"])
    occ = state.grid.occupancy
    assert occ.shape == (2, 16, 16, 16) and state.step == 2
    fracs = occ.reshape(2, -1).float().mean(-1)
    assert bool(((fracs > 0) & (fracs < 0.5)).all())
    seeded = trainer.init_state().grid
    for a, b in zip(state.grid, seeded):
        assert torch.equal(a, b)
    ck = torch.load(sorted((tmp_path / "demo" / "checkpoints")
                           .glob("step_*"))[-1] / "state.pt",
                    weights_only=True)
    assert ck["grid"]["occupancy"].shape == (2, 16, 16, 16)

    out = novel_view.main(demo + ["+render_downscale=20", "+n_frames=2",
                                  *over])
    assert out["frames"] == 2 and out["nonfinite_frames"] == 0
    pose = _pose_npz(tmp_path / "dance.npz")
    out = animate.main(demo + [f"+pose_sequence={pose}",
                               "+render_downscale=20", *over])
    assert out["frames"] == 3 and out["nonfinite_frames"] == 0
    assert read_png(tmp_path / "demo" / "animation" / "0000.png").shape \
        == (54, 54, 4)
