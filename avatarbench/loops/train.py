"""The ``train`` loop: a closed loop of training steps through
``AvatarModel.train_multi_step`` in the Trainer's groups, on batches that
the program's ``FrameDataset`` and ``PatchSampler`` assemble from
synthetic capsule frames made on the device from the seed.

Set-up captures every step graph the window replays; then the checked
steps run through the window's own call and feed: one group of one step
(its Adam moment gives the first gradient), then one whole group; the
window goes on from that state. Once the window has closed, the plain
reference runs the same steps eagerly from the same inputs
(``reference/steps.py``) and the losses, the first gradient and the
parameters' change are compared (``check.train_numbers``).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import build, check, harness, synth
from ..trace import Traced, profiled, span

__all__ = ["run", "numbers", "readings", "train_data", "make_dataset",
           "frame_order", "groups", "draws", "host_group"]


def train_data(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The cell's frames, camera and poses, made from ``seed``."""
    n, S = tr["frames"], tr["size"]
    t = np.arange(n, dtype=np.float32)
    smpl = {"betas": np.zeros((1, 10), np.float32),
            "body_pose": synth.motion(tr["motion"], t, seed, tr["cycle"]),
            "global_orient": synth.motion(tr["orient"], t, seed,
                                          tr["cycle"])[:, :3],
            "transl": np.tile(np.array(tr["transl"], np.float32), (n, 1))}
    K = synth.pinhole(tr["focal"], S, S)
    body = build.make_body(build.reference_lib(), cfg, dev)
    imgs, msks = synth.capsule_frames(body, smpl, K, S, S, seed=seed,
                                      device=dev)
    return {"images": imgs, "masks": msks, "K": K, "smpl": smpl}


def make_dataset(lib, data: dict, tr: dict, seed: int, stream: int):
    """A train split over ``data`` (``lib``'s ``FrameDataset`` and
    ``PatchSampler``) whose sampler and backgrounds draw from generators
    seeded by (``seed``, ``stream``)."""
    ss = np.random.SeedSequence([seed, stream]).spawn(2)
    sampler = lib.data.PatchSampler(
        tr["num_patch"], tr["patch_size"], tr["ratio_mask"],
        rng=np.random.default_rng(ss[0]))
    return lib.data.FrameDataset(
        data["images"], data["masks"], data["K"], np.eye(4), data["smpl"],
        "train", sampler=sampler, bg_rng=np.random.default_rng(ss[1]))


def frame_order(n: int, seed: int):
    """Frame indices epoch after epoch, each epoch a permutation drawn
    from ``seed`` (the Trainer's order)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    while True:
        yield list(rng.permutation(n))


def groups(order, k: int, first: list[int]):
    """The step groups: ``first`` (sizes of the opening groups), then
    groups of ``k`` within each epoch, an epoch's last group smaller."""
    first = list(first)
    for epoch in order:
        pos = 0
        while pos < len(epoch):
            size = first.pop(0) if first else k
            yield epoch[pos:pos + size]
            pos += size


def draws(model, StepDraws, gen, n_rays: int, step: int, k: int) -> list:
    """The draws of steps step .. step + k - 1, in the port's layout
    (``StepDraws``): stratified jitter, sigma noise and, on an update
    step, the grid jitter, from the harness's generator."""
    K = (model.k_cap if model.k_cap is not None
         and model.k_cap < model.n_steps else model.n_steps)
    G = model.grid_size
    out = []
    for s in range(step, step + k):
        jitter = torch.rand((n_rays, model.n_steps), generator=gen,
                            device=gen.device)
        noise = torch.randn((n_rays, K), generator=gen, device=gen.device)
        grid = (torch.rand((G, G, G, 3), generator=gen, device=gen.device)
                if s % model.grid_update_interval == 0 else None)
        out.append(StepDraws(jitter, noise, grid))
    return out


def host_group(ds, idxs) -> dict:
    """A group's batch on the host: each key stacked over its steps."""
    items = [ds[int(i)] for i in idxs]
    return {k: np.stack([np.asarray(b[k]) for b in items]) for k in items[0]}


def _state_tensors(state, field) -> list[torch.Tensor]:
    opt = state.opt_state
    m, v = opt.moments("field")
    return (list(field.parameters()) + m + v
            + [opt.count, opt.notfinite_count, *state.grid[:2]])


def run(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool,
        dev, t_process: float) -> SimpleNamespace:
    phase = harness.Phases(t_process, dev)
    lib = build.program_lib()
    StepDraws = lib.train.StepDraws
    phase("imports")
    if dev.type == "cuda":
        harness.build_kernels()
    phase("kernels")
    data = train_data(cfg, tr, seed, dev)
    phase("frames")
    n_frames = tr["frames"]
    model = build.make_model(lib, cfg, dev, steps_per_epoch=n_frames)
    state = model.init(data["smpl"]["betas"])
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), seed, dev))
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    K = tr["group"]
    stage = harness.Staging(dev)

    # every graph the window can replay: each of the step's graph keys
    # (grid update, the 500-step latch, sigma noise), captured on the
    # state's own tensors, which are then put back as they were
    phase("model")
    warm_ds = make_dataset(lib, data, tr, seed, 10)
    warm_gen = torch.Generator(device=dev).manual_seed(seed + 7)
    with torch.no_grad():
        snap = [t.clone() for t in _state_tensors(state, model.field)]
    for s in tr["warm_steps"]:
        b = stage(host_group(warm_ds, [s % n_frames]))
        model.train_multi_step(state._replace(step=s), b,
                               draws(model, StepDraws, warm_gen, n_rays, s, 1))
    harness.sync(dev)
    with torch.no_grad():
        for t, v in zip(_state_tensors(state, model.field), snap):
            t.copy_(v)
    del snap

    # the checked steps, through the window's call and feed: a group of
    # one step, then a whole group; the window goes on from there
    phase("captures")
    ds = make_dataset(lib, data, tr, seed, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = groups(frame_order(n_frames, seed), K, [1])
    p0 = {n: p.detach().cpu().clone()
          for n, p in model.field.named_parameters()}
    losses, g0, step = [], None, 0
    for _ in range(2):
        idxs = next(it)
        state, ls = model.train_multi_step(
            state, stage(host_group(ds, idxs)),
            draws(model, StepDraws, gen, n_rays, step, len(idxs)))
        step += len(idxs)
        losses.append(float(ls["loss"]))
        if step == 1:
            b1 = model.optimizer.betas[0]
            g0 = {n: (m / (1 - b1)).cpu() for n, m in zip(
                dict(model.field.named_parameters()),
                state.opt_state.moments("field")[0])}
    p_end = {n: p.detach().cpu().clone()
             for n, p in model.field.named_parameters()}
    phase("checked_steps")

    window = min(seconds, tr["trace_seconds"]) if trace else seconds
    before = harness.counters()
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
                host = host_group(ds, idxs)
                batch_s += time.perf_counter() - tb
            with span("stage", trace):
                b = stage(host)
            with span("train_multi_step", trace):
                state, ls = model.train_multi_step(
                    state, b, draws(model, StepDraws, gen, n_rays, step,
                                    len(idxs)))
            step += len(idxs)
            steps += len(idxs)
            if time.perf_counter() - t0 >= window:
                break
        with span("drain", trace):
            harness.sync(dev)
        window_s = time.perf_counter() - t0
    counts = harness.delta(harness.counters(), before)
    applied = int(state.opt_state.count) - count0
    peak = harness.peak(dev)
    out = SimpleNamespace(
        notes={"steps": steps, "window_s": window_s, "batch_s": batch_s,
               "first_step": step - steps, "setup": phase.at},
        kind="train", setup_s=setup_s, window_s=window_s, steps=steps,
        attempted=steps, failed=steps - applied,   # updates skipped
        batch_s=batch_s, counters=counts, memory_peak_bytes=peak,
        trace=Traced(holder[0], window_s) if trace else None,
        cfg=cfg, tr=tr, seed=seed,
        program={"losses": losses, "g0": g0, "p0": p0, "p_end": p_end},
        data=data)
    del model, state, ds, warm_ds, stage
    harness.free(dev)
    return out


def program_numbers(out) -> dict:
    p = out.program
    return {"losses": p["losses"], "g0": p["g0"],
            "delta": {n: p["p_end"][n] - p["p0"][n] for n in p["p0"]}}


def reference(out, dev, **kw) -> dict:
    from ..reference import steps
    model = check.load_reference(out.cfg["name"]).make_model(
        out.cfg, dev, steps_per_epoch=out.tr["frames"])
    return steps.train_steps(model, out.cfg, out.tr, out.seed, out.data,
                             dev, **kw)


def numbers(out, dev) -> dict:
    """The compared numbers: the program's checked steps against the
    reference's."""
    return check.train_numbers(program_numbers(out), reference(out, dev))


def readings(out, dev, controls: bool) -> list[dict]:
    """The program's numbers (the lower reading); with ``controls`` also
    the control's (the reference one precision step down) and each
    fault's, planted in the reference put in the program's place: half of
    each batch left out, and every step of a group on the group's first
    batch."""
    ref = reference(out, dev)
    got = [{"what": "program",
            **check.train_numbers(program_numbers(out), ref)}]
    if controls:
        for what, kw in (("control", {"lowered": True}),
                         ("fault_half", {"fault": "half"}),
                         ("fault_first_batch", {"fault": "first_batch"})):
            got.append({"what": what, **check.train_numbers(
                reference(out, dev, **kw), ref)})
    return got
