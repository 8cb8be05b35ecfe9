"""The ``fit`` loop: the in-the-wild demo's SMPL fit as a closed loop of
training steps through ``AvatarModel.train_multi_step`` in the Trainer's
groups, the model built with the SMPL deformer, ``optimize_smpl`` (the
per-frame SMPL leaves in the optimizer's ``smpl`` group) and the LPIPS
loss; batches from the program's ``FrameDataset`` and ``PatchSampler``
over synthetic capsule frames made on the device from the seed.

The frames show the body in its true poses; the dataset and the SMPL
leaves start from those poses plus seeded Gaussian noise (``start_noise``
of the traffic, radians and metres), as the demo starts from ROMP's
estimate. Set-up builds the three kernel libraries and captures every
step graph the window replays; then the checked steps run through the
window's own call and feed (``train``'s), and the window goes on from that
state. Once the window has closed the plain reference
(``reference/smpl-ngp-fit.py``) runs the same steps eagerly from the same
inputs: the field's numbers as ``check.train_numbers`` gives them, and
``pose_grad_gap`` and ``pose_delta_gap``, the worst leaf-norm gaps
(``check.leaf_gaps``) of the SMPL leaves' first gradient and change.

The window's counters add the nearest-vertex kernel's (``knn``) and the
LPIPS trunk's (``lpips``) to the head's and the encode's; a program
without the LPIPS counters gives no ``lpips`` entry.
"""
from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from .. import build, check, harness
from ..trace import Traced, profiled, span
from . import train as train_loop

__all__ = ["run", "numbers", "readings", "fit_data", "make_model",
           "counters", "pose_numbers"]

REFERENCE = "smpl-ngp-fit"


def fit_data(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The cell's frames and camera (``train``'s, in the true poses), the
    true poses (``"true"``) and the noisy start that the dataset and the
    SMPL leaves carry (``"smpl"``)."""
    data = train_loop.train_data(cfg, tr, seed, dev)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    start = {k: np.array(v, np.float32) for k, v in data["smpl"].items()}
    for k, std in tr["start_noise"].items():
        start[k] += (std * rng.standard_normal(start[k].shape)).astype(
            np.float32)
    return {**data, "true": data["smpl"], "smpl": start}


def make_model(cfg: dict, dev, steps_per_epoch: int):
    """The program's ``AvatarModel`` of the configuration, with its LPIPS
    module: the seeded random VGG trunk, never a trunk file."""
    lib = build.program_lib()
    from instantavatar_torch.losses import load_lpips
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the random trunk's notice
        lpips = load_lpips(cfg["lpips"]["net"], allow_random=True,
                           device=dev)
    if lpips.numerically_matched:
        raise SystemExit("a trunk file was found; the configuration's "
                         "trunk is the seeded random one")
    body = build.make_body(lib, cfg, dev)
    return lib.train.AvatarModel(
        body, build.make_field(lib, cfg, dev),
        build.construct(lib, cfg["deformer"], body), **cfg["avatar"],
        lpips_fn=lpips, optimizer=build.construct(
            lib, cfg["optimizer"], steps_per_epoch=steps_per_epoch))


def build_kernels() -> None:
    """Build (or load) the three kernel libraries at once."""
    from instantavatar_torch.kernels import build_knn_library
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(harness.build_kernels),
                  pool.submit(build_knn_library)]:
            f.result()


def counters() -> dict:
    """``harness.counters`` and the nearest-vertex kernel's and the LPIPS
    trunk's (launches, rows), where the program has them."""
    from instantavatar_torch.kernels import nearest_vertex_cuda
    from instantavatar_torch.losses import LPIPS
    out = harness.counters()
    out["knn"] = (nearest_vertex_cuda.launches, nearest_vertex_cuda.rows)
    if hasattr(LPIPS, "launches"):
        out["lpips"] = (LPIPS.launches, LPIPS.rows)
    return out


def _state_tensors(state, field) -> list[torch.Tensor]:
    opt = state.opt_state
    out = list(field.parameters()) + list(state.smpl)
    for group in ("field", "smpl"):
        m, v = opt.moments(group)
        out += m + v
    return out + [opt.count, opt.notfinite_count, *state.grid[:2]]


def _first_gradient(model, state, group: str, names) -> dict:
    """The first step's gradient per leaf, from Adam's first moment."""
    b1 = model.optimizer.betas[0]
    return {n: (m / (1 - b1)).cpu()
            for n, m in zip(names, state.opt_state.moments(group)[0])}


def run(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool,
        dev, t_process: float) -> SimpleNamespace:
    phase = harness.Phases(t_process, dev)
    lib = build.program_lib()
    StepDraws = lib.train.StepDraws
    phase("imports")
    if dev.type == "cuda":
        build_kernels()
    phase("kernels")
    data = fit_data(cfg, tr, seed, dev)
    phase("frames")
    n_frames = tr["frames"]
    model = make_model(cfg, dev, n_frames)
    state = model.init(data["smpl"]["betas"], smpl_params=data["smpl"])
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), seed, dev))
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    K = tr["group"]
    stage = harness.Staging(dev)

    # every graph the window can replay, captured on the state's own
    # tensors, which are then put back as they were
    phase("model")
    warm_ds = train_loop.make_dataset(lib, data, tr, seed, 10)
    warm_gen = torch.Generator(device=dev).manual_seed(seed + 7)
    with torch.no_grad():
        snap = [t.clone() for t in _state_tensors(state, model.field)]
    for s in tr["warm_steps"]:
        b = stage(train_loop.host_group(warm_ds, [s % n_frames]))
        model.train_multi_step(state._replace(step=s), b, train_loop.draws(
            model, StepDraws, warm_gen, n_rays, s, 1))
    harness.sync(dev)
    with torch.no_grad():
        for t, v in zip(_state_tensors(state, model.field), snap):
            t.copy_(v)
    del snap

    # the checked steps, through the window's call and feed
    phase("captures")
    ds = train_loop.make_dataset(lib, data, tr, seed, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = train_loop.groups(train_loop.frame_order(n_frames, seed), K, [1])
    names = [n for n, _ in model.field.named_parameters()]
    p0 = {n: p.detach().cpu().clone()
          for n, p in model.field.named_parameters()}
    q0 = {k: t.detach().cpu().clone() for k, t in state.smpl._asdict().items()}
    losses, g0, pg0, step = [], None, None, 0
    for _ in range(2):
        idxs = next(it)
        state, ls = model.train_multi_step(
            state, stage(train_loop.host_group(ds, idxs)),
            train_loop.draws(model, StepDraws, gen, n_rays, step, len(idxs)))
        step += len(idxs)
        losses.append(float(ls["loss"]))
        if step == 1:
            g0 = _first_gradient(model, state, "field", names)
            pg0 = _first_gradient(model, state, "smpl", state.smpl._fields)
    p_end = {n: p.detach().cpu().clone()
             for n, p in model.field.named_parameters()}
    q_end = {k: t.detach().cpu().clone()
             for k, t in state.smpl._asdict().items()}
    phase("checked_steps")

    window = min(seconds, tr["trace_seconds"]) if trace else seconds
    before = counters()
    count0 = int(state.opt_state.count)
    harness.settle()
    steps = 0
    batch_s = 0.0
    with profiled(trace) as holder:
        t0 = time.perf_counter()
        setup_s = time.time() - t_process
        while True:
            with span("batch", trace):
                tb = time.perf_counter()
                idxs = next(it)
                host = train_loop.host_group(ds, idxs)
                batch_s += time.perf_counter() - tb
            with span("stage", trace):
                b = stage(host)
            with span("train_multi_step", trace):
                state, ls = model.train_multi_step(
                    state, b, train_loop.draws(model, StepDraws, gen, n_rays,
                                               step, len(idxs)))
            step += len(idxs)
            steps += len(idxs)
            if time.perf_counter() - t0 >= window:
                break
        with span("drain", trace):
            harness.sync(dev)
        window_s = time.perf_counter() - t0
    counts = harness.delta(counters(), before)
    applied = int(state.opt_state.count) - count0
    peak = harness.peak(dev)
    out = SimpleNamespace(
        notes={"steps": steps, "window_s": window_s, "batch_s": batch_s,
               "first_step": step - steps, "setup": phase.at,
               "counters": counts},
        kind="train", setup_s=setup_s, window_s=window_s, steps=steps,
        attempted=steps, failed=steps - applied,   # updates skipped
        batch_s=batch_s, counters=counts, memory_peak_bytes=peak,
        trace=Traced(holder[0], window_s) if trace else None,
        cfg=cfg, tr=tr, seed=seed,
        n_verts=int(model.body.v_template.shape[0]),
        program={"losses": losses, "g0": g0, "p0": p0, "p_end": p_end,
                 "pose_g0": pg0, "q0": q0, "q_end": q_end},
        data=data)
    del model, state, ds, warm_ds, stage
    harness.free(dev)
    return out


def program_numbers(out) -> dict:
    p = out.program
    return {"losses": p["losses"], "g0": p["g0"],
            "delta": {n: p["p_end"][n] - p["p0"][n] for n in p["p0"]},
            "pose_g0": p["pose_g0"],
            "pose_delta": {k: p["q_end"][k] - p["q0"][k] for k in p["q0"]}}


def reference(out, dev, **kw) -> dict:
    ref = check.load_reference(REFERENCE)
    model = ref.make_model(out.cfg, dev, steps_per_epoch=out.tr["frames"])
    return ref.fit_steps(model, out.cfg, out.tr, out.seed, out.data, dev,
                         **kw)


def pose_numbers(prog: dict, ref: dict) -> dict:
    """The SMPL leaves' worst gaps (``check.leaf_gaps``): of the first
    gradient and of the change over the checked steps, over the leaves
    whose reference gradient is not negligible (``check.kept_leaves``)."""
    leaves = check.kept_leaves(ref["pose_g0"])
    grad = check.leaf_gaps(prog["pose_g0"], ref["pose_g0"], leaves)
    delta = check.leaf_gaps(prog["pose_delta"], ref["pose_delta"], leaves)
    return {"pose_grad_gap": max(grad.values()),
            "pose_delta_gap": max(delta.values()),
            "_pose_leaves": (max(grad, key=grad.get),
                             max(delta, key=delta.get), len(leaves)),
            "_pose_grad_gaps": grad, "_pose_delta_gaps": delta}


def compare(prog: dict, ref: dict) -> dict:
    return {**check.train_numbers(prog, ref), **pose_numbers(prog, ref)}


def numbers(out, dev) -> dict:
    """The compared numbers: the program's checked steps against the
    reference's, the field's and the SMPL leaves'."""
    return compare(program_numbers(out), reference(out, dev))


def readings(out, dev, controls: bool) -> list[dict]:
    """The program's numbers (the lower reading); with ``controls`` also
    the control's (the reference one precision step down) and each
    fault's, planted in the reference put in the program's place: half of
    each batch left out, every step of a group on the group's first
    batch, the SMPL leaves never updated, the LPIPS term left out."""
    ref = reference(out, dev)
    got = [{"what": "program", **compare(program_numbers(out), ref)}]
    if controls:
        for what, kw in (("control", {"lowered": True}),
                         ("fault_half", {"fault": "half"}),
                         ("fault_first_batch", {"fault": "first_batch"}),
                         ("fault_pose_frozen", {"fault": "pose_frozen"}),
                         ("fault_lpips_off", {"fault": "lpips_off"})):
            got.append({"what": what,
                        **compare(reference(out, dev, **kw), ref)})
    return got
