"""Training harness: the explicit train / validate / test loops.

Port of ``instantavatar_tpu/train/harness.py``: an epoch loop with one
frame per step, validation every N epochs (val PSNR, the progression
image, rgb/alpha error maps and a canonical-pose sanity render), the
best-val-PSNR checkpoint plus the latest, auto-resume from the latest
checkpoint, and a test loop that writes ``test/{i}.png`` [gt | pred |
error] triptychs and ``results.txt``.

Checkpoints keep the JAX layout, ``checkpoints/step_%08d/`` with a
``metrics.json``; inside is one ``torch.save`` of plain containers of
tensors (``state.pt``): the field's ``state_dict``, the Adam moments (per
group) and counts, the density grid, the SNARF canonical bake, the input
normalization, the step and, when the model optimizes them, the per-frame
SMPL parameters. The grid is the stacked per-frame grids with
``smpl_init``; the canonical state is the deformer's own type
(``SnarfCanonical`` or ``SMPLCanonical``) and comes back as the type the
target state holds. ``graft`` takes a train run's field, grid, bake and
normalization into a fresh state (the refine flow). Scalars go to
``tensorboard/scalars.jsonl`` under the JAX package's TensorBoard tags;
images go out as PNGs.

The step's random draws come from a ``torch.Generator`` seeded from
``seed``. As in JAX, the loop trains ``multi_step`` steps per call
(``AvatarModel.train_multi_step``, default 4) on groups of consecutive
indices of the epoch's permutation (``iterate_grouped``; the last group
of an epoch is smaller), each group stacked on a leading axis and copied
from pinned host memory with ``non_blocking=True``. On the card each
step of a group is one replay of its captured graph, with no host sync
in between; the host reads the losses only to log them. JAX's prefetch
thread and one-blob transfer work around a remote TPU's transfer cost
and have no counterpart here.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..render.density_grid import DensityGridState
from ..utils.image_io import jet, write_png
from .model import AvatarModel, RenderSession, TrainState

__all__ = ["Trainer", "save_checkpoint", "restore_checkpoint",
           "latest_checkpoint", "graft", "iterate_grouped"]


# -- checkpoints -------------------------------------------------------------

def _checkpoint_contents(state: TrainState, field) -> dict:
    adam = None
    opt = state.opt_state
    if opt is not None:
        adam = {"count": int(opt.count),
                "notfinite_count": int(opt.notfinite_count)}
        for group, prefix in (("field", ""), ("smpl", "smpl_")):
            mu, nu = opt.moments(group) or ([], [])
            adam[prefix + "exp_avg"], adam[prefix + "exp_avg_sq"] = mu, nu
    return {"field": field.state_dict(), "adam": adam,
            "grid": state.grid._asdict(),
            "deformer_cano": state.deformer_cano._asdict(),
            "center": state.center, "scale": state.scale,
            "step": int(state.step),
            "smpl": (None if state.smpl is None else
                     {k: v.detach() for k, v in state.smpl._asdict().items()})}


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, field,
                    metrics: dict | None = None) -> Path:
    """Write ``state`` (and ``field``, whose module holds the parameters)
    to ``ckpt_dir/step_%08d``; the directory appears complete or not at
    all."""
    ckpt_dir = Path(ckpt_dir).absolute()
    path = ckpt_dir / f"step_{int(state.step):08d}"
    tmp = ckpt_dir / f".tmp_{path.name}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(_checkpoint_contents(state, field), tmp / "state.pt")
    if metrics is not None:
        (tmp / "metrics.json").write_text(json.dumps(metrics))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    cands = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    return cands[-1] if cands else None


def _load(path: str | Path, target: TrainState, field) -> dict:
    """Read a checkpoint onto the target's device and load its field
    parameters into ``field``."""
    ck = torch.load(Path(path) / "state.pt", weights_only=True,
                    map_location=target.center.device)
    field.load_state_dict(ck["field"])
    return ck


def restore_checkpoint(path: str | Path, target: TrainState,
                       field) -> TrainState:
    """Restore a checkpoint into ``field`` and the structure of ``target``
    (an initialized state whose optimizer is bound to ``field`` and to
    ``target.smpl``, whose leaves take the saved values in place), on the
    target's device."""
    ck = _load(path, target, field)
    opt, adam = target.opt_state, ck["adam"]
    if opt is not None and adam is not None:
        for group, prefix in (("field", ""), ("smpl", "smpl_")):
            if adam.get(prefix + "exp_avg"):
                opt.load_moments(adam[prefix + "exp_avg"],
                                 adam[prefix + "exp_avg_sq"], adam["count"],
                                 group=group)
        opt.count = adam["count"]
        opt.notfinite_count = adam["notfinite_count"]
    if (ck.get("smpl") is None) != (target.smpl is None):
        raise ValueError(f"{path}: the checkpoint's SMPL parameters do not "
                         f"match the model's optimize_smpl")
    if target.smpl is not None:
        with torch.no_grad():
            for k, v in target.smpl._asdict().items():
                v.copy_(ck["smpl"][k])
    return target._replace(
        grid=DensityGridState(**ck["grid"]),
        deformer_cano=type(target.deformer_cano)(**ck["deformer_cano"]),
        center=ck["center"], scale=ck["scale"], step=ck["step"])


def graft(path: str | Path, target: TrainState, field) -> TrainState:
    """The field parameters, grid, canonical bake and input normalization
    of a checkpoint on a fresh ``target``, which keeps its own SMPL
    parameters, optimizer state and step (the refine flow's cross-stage
    restore: a train run's avatar, the test split's poses)."""
    ck = _load(path, target, field)
    return target._replace(
        grid=DensityGridState(**ck["grid"]),
        deformer_cano=type(target.deformer_cano)(**ck["deformer_cano"]),
        center=ck["center"], scale=ck["scale"])


def _to_image(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def iterate_grouped(getter, indices, group: int):
    """Host batches of ``group`` consecutive ``indices`` (JAX's
    ``DevicePrefetcher.iterate_grouped``): each key of ``getter(i)``
    stacked on a leading axis, the last group smaller when ``group``
    does not divide the count."""
    indices = list(indices)
    for s in range(0, len(indices), group):
        items = [getter(int(i)) for i in indices[s:s + group]]
        yield {k: np.stack([np.asarray(b[k]) for b in items])
               for k in items[0]}


def _to_device(batch: dict[str, Any], device: torch.device) -> dict:
    """Host batch -> tensors on ``device``, through pinned memory."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Trainer:
    """Explicit train/val/test loops around an AvatarModel."""

    def __init__(self, avatar: AvatarModel, datamodule,
                 workdir: str | Path = ".",
                 max_epochs: int = 30,
                 check_val_every_n_epoch: int = 10,
                 log_every_n_steps: int = 50,
                 resume: bool = True,
                 seed: int = 42,
                 evaluator=None,
                 lr_schedule=None,
                 multi_step: int = 4):
        self.avatar = avatar
        self.dm = datamodule
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / "checkpoints"
        self.max_epochs = max_epochs
        self.check_val_every = check_val_every_n_epoch
        self.log_every = log_every_n_steps
        self.resume = resume
        self.seed = seed
        self.evaluator = evaluator
        # steps per train_multi_step call (JAX's default); 1 steps one at
        # a time
        self.multi_step = max(1, int(multi_step))
        # step -> lr, for the train/lr scalar
        self.lr_schedule = lr_schedule
        # one render session for the run: val/test frames of one pose
        # share their grid and bake
        self.render_session = RenderSession()

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        """One TensorBoard scalar, as a JSON line."""
        d = self.workdir / "tensorboard"
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "scalars.jsonl", "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")

    def init_state(self) -> TrainState:
        """A fresh state: field params from a generator seeded ``seed``,
        the canonical bake from the training split's betas and, when the
        model optimizes SMPL parameters or seeds per-frame grids from them
        (``smpl_init``), those of the training split."""
        gen = torch.Generator(device=self.avatar.device).manual_seed(
            self.seed)
        trainset = self.dm.trainset
        return self.avatar.init(
            trainset.smpl_params["betas"], generator=gen,
            smpl_params=(trainset.get_smpl_params()
                         if self.avatar.optimize_smpl or self.avatar.smpl_init
                         else None))

    # -- fit ------------------------------------------------------------------

    def fit(self, state: TrainState | None = None) -> TrainState:
        trainset = self.dm.trainset
        steps_per_epoch = len(trainset)
        dev = self.avatar.device
        if state is None:
            state = self.init_state()
        if self.resume:
            last = latest_checkpoint(self.ckpt_dir)
            if last is not None:
                state = restore_checkpoint(last, state, self.avatar.field)
                print(f"[trainer] resumed from {last}")

        step = start_step = int(state.step)
        start_epoch = step // max(steps_per_epoch, 1)
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        # wall seconds of each epoch's steps, batch assembly included, and
        # the host seconds of the batch assembly alone
        self.epoch_seconds: list[float] = []
        self.batch_seconds = 0.0
        self.last_losses: dict = {}   # the last step's loss components
        t0 = time.time()
        for epoch in range(start_epoch, self.max_epochs):
            t_epoch = time.perf_counter()
            t_batch = time.perf_counter()
            for host in iterate_grouped(trainset.__getitem__,
                                        rng.permutation(steps_per_epoch),
                                        self.multi_step):
                batches = _to_device(host, dev)
                self.batch_seconds += time.perf_counter() - t_batch
                n = len(host["idx"])
                n_rays = int(np.prod(host["rays_o"].shape[1:-1]))
                state, losses = self.avatar.train_multi_step(
                    state, batches,
                    self.avatar.draw_steps(gen, n_rays, step, n))
                self.last_losses = losses
                step += n
                if step % self.log_every < n:
                    scal = {k: float(v) for k, v in losses.items()
                            if v.ndim == 0}
                    if self.lr_schedule is not None:
                        scal["lr"] = float(self.lr_schedule(step))
                    for k, v in scal.items():
                        self.log_scalar(f"train/{k}", v, step)
                    print(f"[trainer] epoch {epoch} step {step} "
                          f"loss={scal.get('loss', float('nan')):.4f} "
                          f"({time.time() - t0:.0f}s)")
                t_batch = time.perf_counter()

            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_seconds.append(time.perf_counter() - t_epoch)

            if (epoch + 1) % self.check_val_every == 0 \
                    or epoch == self.max_epochs - 1:
                metrics = self.validate(state, epoch)
                save_checkpoint(self.ckpt_dir, state, self.avatar.field,
                                {"epoch": epoch, **metrics})
                self._prune_checkpoints(keep=2)
        self.steps_run = step - start_step
        if self.steps_run:
            secs = sum(self.epoch_seconds)
            print(f"[trainer] {self.steps_run} steps in {secs:.1f} s "
                  f"({1e3 * secs / self.steps_run:.1f} ms/step, of which "
                  f"{1e3 * self.batch_seconds / self.steps_run:.2f} ms "
                  f"batch assembly)")
        return state

    def _prune_checkpoints(self, keep: int = 2):
        """Keep the best-val-PSNR checkpoint plus the latest (the
        reference's ModelCheckpoint save_top_k=1 + save_last)."""
        cands = sorted(p for p in self.ckpt_dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_"))
        if len(cands) <= keep:
            return

        def psnr_of(p):
            try:
                return json.loads((p / "metrics.json").read_text()) \
                    .get("psnr", -1e9)
            except (OSError, ValueError):
                return -1e9

        keep_set = {cands[-1], max(cands, key=psnr_of)}
        for p in cands:
            if p not in keep_set:
                shutil.rmtree(p)

    # -- validation -----------------------------------------------------------

    def validate(self, state: TrainState, epoch: int = 0) -> dict:
        """Validation pass: val PSNR, rgb loss and the evaluated-sample
        counters over every val frame; for frame 0 the progression image
        ``val/epoch_%04d.png`` [gt | pred], the error maps
        ``val/errmap_%04d.png`` [gt | rgb error | alpha error] and the
        canonical-pose sanity render ``val/cano_pose_%04d.png`` [gt | pred
        | canonical pose] (a deformer failure shows there before it shows
        in the metrics)."""
        if not hasattr(self.dm, "valset") or len(self.dm.valset) == 0:
            return {}
        ds = self.dm.valset
        H, W = ds.image_shape
        step = int(state.step)
        psnrs, rgb_losses, c_avg, c_max = [], [], [], []
        stash: dict = {}

        def batch_gen():
            for i in range(len(ds)):
                b = ds[i]
                stash[i] = (b["rgb"], b["alpha"])
                if i == 0:
                    stash["b0"] = b
                yield b

        first = None
        for i, out in enumerate(self.avatar.render_frames(
                state, batch_gen(), image_shape=(H, W),
                session=self.render_session)):
            pred = out["rgb"].reshape(H, W, 3).cpu().numpy()
            rgb, alpha = stash.pop(i)
            gt = rgb.reshape(H, W, 3)
            mse = float(np.mean((pred - gt) ** 2))
            rgb_losses.append(mse)
            psnrs.append(-10 * np.log10(max(mse, 1e-12)))
            c_avg.append(float(out["counter"].mean()))
            c_max.append(float(out["counter"].max()))
            if i == 0:
                first = (pred, gt, out["alpha"].reshape(H, W).cpu().numpy(),
                         alpha.reshape(H, W))

        if first is not None:
            pred, gt, alpha, alpha_gt = first
            vdir = self.workdir / "val"
            vdir.mkdir(parents=True, exist_ok=True)
            # images are BGR, as the datasets read them
            write_png(vdir / f"epoch_{epoch:04d}.png",
                      _to_image(np.concatenate([gt, pred], axis=1)))
            err_rgb = np.sqrt(((pred - gt) ** 2).sum(-1)) / np.sqrt(3)
            panel = np.concatenate(
                [gt, jet(err_rgb)[..., ::-1],
                 jet(np.abs(alpha - alpha_gt))[..., ::-1]], axis=1)
            write_png(vdir / f"errmap_{epoch:04d}.png", _to_image(panel))

            # canonical-pose sanity render: zeroed body pose with the legs
            # slightly apart, same camera and translation
            cano = dict(stash["b0"])
            bp = np.zeros_like(np.asarray(cano["body_pose"]))
            bp[..., 2], bp[..., 5] = 0.5, -0.5
            cano["body_pose"] = bp
            cano_out = self.avatar.render_frame(
                state, cano, image_shape=(H, W), session=self.render_session)
            cano_img = cano_out["rgb"].reshape(H, W, 3).cpu().numpy()
            write_png(vdir / f"cano_pose_{epoch:04d}.png", _to_image(
                np.concatenate([gt, pred, cano_img], axis=1)))

        metrics = {"psnr": float(np.mean(psnrs))}
        self.log_scalar("val/psnr", metrics["psnr"], step)
        self.log_scalar("val/rgb_loss", float(np.mean(rgb_losses)), step)
        self.log_scalar("val/counter_avg", float(np.mean(c_avg)), step)
        self.log_scalar("val/counter_max", float(np.max(c_max)), step)
        print(f"[trainer] val epoch {epoch}: psnr={metrics['psnr']:.2f} "
              f"counter_avg={np.mean(c_avg):.1f}")
        return metrics

    # -- test -------------------------------------------------------------------

    def test(self, state: TrainState, split: str = "test") -> dict:
        """Render the split, write [gt | pred | error] triptychs
        ``test/{i}.png`` and ``results.txt`` (mean PSNR and SSIM; LPIPS is
        listed as skipped, with the reason)."""
        from ..utils.metrics import Evaluator
        ds = getattr(self.dm, f"{split}set")
        H, W = ds.image_shape
        out_dir = self.workdir / "test"
        out_dir.mkdir(parents=True, exist_ok=True)
        if self.evaluator is None:
            self.evaluator = Evaluator(device=self.avatar.device)
        agg: dict[str, list] = {}
        gts: dict[int, np.ndarray] = {}

        def batch_gen():
            for i in range(len(ds)):
                b = ds[i]
                gts[i] = b["rgb"]
                yield b

        for i, out in enumerate(self.avatar.render_frames(
                state, batch_gen(), image_shape=(H, W),
                session=self.render_session)):
            pred = out["rgb"].reshape(H, W, 3).cpu().numpy()
            gt = gts.pop(i).reshape(H, W, 3)
            err = np.abs(pred - gt).mean(-1, keepdims=True)
            err = np.repeat(err / max(err.max(), 1e-6), 3, axis=-1)
            write_png(out_dir / f"{i}.png",
                      _to_image(np.concatenate([gt, pred, err], axis=1)))
            for k, v in self.evaluator(pred, gt).items():
                agg.setdefault(k, []).append(v)
        results = {k: float(np.mean(v)) for k, v in agg.items()}
        txt = "\n".join(f"{k}: {v}" for k, v in results.items())
        if "lpips" not in results:
            reason = getattr(self.evaluator, "lpips_skip_reason", None) \
                or "no LPIPS evaluator"
            txt += f"\nlpips: SKIPPED ({reason})"
        (self.workdir / "results.txt").write_text(txt + "\n")
        print(f"[trainer] {split}: {results}")
        return results
