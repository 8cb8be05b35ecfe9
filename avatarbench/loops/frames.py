"""The ``frames`` loop: a closed loop of frames through
``AvatarModel.render_frames`` on one ``RenderSession``, each frame done
when its uint8 RGBA is on the host, as the CLIs write it; the poses are a
turntable or a seeded motion (``"poses"`` in the traffic file).

A frame's batch is the CLIs' camera as the flat render reads it: the
pinhole's ``ray_basis``, one background colour (the program ships a
uniform per-pixel background as one colour), the body's parameters and
the frame's index. Set-up renders the traffic's warm-up frames, which
learn every budget and capture every graph the window replays. The
window keeps a sample of its frames drawn from the seed (reservoir
sampling, so any frame may be drawn whatever the window's length) and
the frame of most kept samples; once it has closed, the plain reference
renders those frames again from their inputs and the worst RGBA gap is
compared (``check.frame_numbers``).
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import torch

from .. import build, check, harness, synth
from ..trace import Traced, profiled, span

__all__ = ["run", "numbers", "readings", "camera", "frame_batch",
           "frame_times", "Keep"]


def camera(tr: dict) -> dict:
    """The CLIs' camera (``make_camera``): ``size`` x ``size`` pixels,
    ``focal``, at the origin; the batch keys every frame shares."""
    S = tr["size"]
    return {"ray_basis": synth.ray_basis(synth.pinhole(tr["focal"], S, S)),
            "bg_color": np.ones(3, np.float32),
            "betas": np.zeros(10, np.float32)}


def frame_batch(tr: dict, shared: dict, seed: int, t: float) -> dict:
    """The batch of frame time ``t``: a turntable view or a motion pose."""
    if tr["poses"] == "turntable":
        start = np.random.default_rng(seed).uniform(0, 2 * np.pi)
        body_pose = np.zeros(69, np.float32)
        for k, v in tr["body_pose"].items():
            body_pose[int(k)] = v
        orient = synth.yaw(start + 2 * np.pi * t / tr["views"])
    else:
        body_pose = synth.motion(tr["motion"], np.array([t]), seed,
                                 tr["cycle"])[0]
        orient = np.zeros(3, np.float32)
    return {**shared, "global_orient": orient, "body_pose": body_pose,
            "transl": np.array(tr["transl"], np.float32),
            "idx": np.int32(0)}


def frame_times(start: int, count: int | None = None):
    """Frame times start, start + 1, ... (``count`` of them, or without
    end)."""
    i = start
    while count is None or i < start + count:
        yield float(i)
        i += 1


class Keep:
    """The frames kept for the comparison: ``k`` drawn from the seed by
    reservoir sampling over however many frames come, and the frame of
    most kept samples. Each offered frame is copied only when kept."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
        self.drawn: list = []   # (index, time, rgba)
        self.most = None        # (kept samples, index, time, rgba)
        self.seen = 0

    def offer(self, t: float, rgba: np.ndarray, kept: int) -> None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.drawn.append((i, t, rgba.copy()))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.drawn[j] = (i, t, rgba.copy())
        if self.most is None or kept > self.most[0]:
            self.most = (kept, i, t, rgba.copy())

    def frames(self) -> list:
        """(index, time, rgba) of every kept frame, in window order."""
        got = {i: (i, t, f) for i, t, f in self.drawn}
        if self.most is not None:
            _, i, t, f = self.most
            got[i] = (i, t, f)
        return [got[i] for i in sorted(got)]


def run(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool,
        dev, t_process: float) -> SimpleNamespace:
    phase = harness.Phases(t_process, dev)
    lib = build.program_lib()
    phase("imports")
    if dev.type == "cuda":
        harness.build_kernels()
    phase("kernels")
    model = build.make_model(lib, cfg, dev)
    state = model.init(np.zeros((1, 10), np.float32))
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), seed, dev))
    S = tr["size"]
    phase("model")
    shared = camera(tr)
    session = lib.train.RenderSession()
    pinned = dev.type == "cuda"
    host = torch.empty(S * S * 4 + 1, dtype=torch.uint8, pin_memory=pinned)

    def to_host(out) -> tuple[np.ndarray, bool]:
        """The frame's uint8 RGBA on the host, as the CLIs write it, and
        whether every value was finite (one copy for both, into one
        pinned buffer that every frame reuses)."""
        rgba = torch.cat([out["rgb"].reshape(S, S, 3),
                          out["alpha"].reshape(S, S, 1)], -1)
        u8 = (rgba.clamp(0, 1) * 255).to(torch.uint8).reshape(-1)
        finite = torch.isfinite(rgba).all().to(torch.uint8).reshape(1)
        host.copy_(torch.cat([u8, finite]))
        got = host.numpy()
        return got[:-1].reshape(S, S, 4), bool(got[-1])

    # warm-up: every budget and graph the window's frames will use
    warm = [frame_batch(tr, shared, seed, t)
            for t in frame_times(tr["warm_start"], tr["warm_frames"])]
    for out in model.render_frames(state, warm, image_shape=(S, S),
                                   session=session, depth=tr["depth"]):
        to_host(out)
    phase("warm_frames")
    del warm

    window = min(seconds, tr["trace_seconds"]) if trace else seconds
    taken: list[float] = []
    times_t: list[float] = []
    done: list[float] = []
    kept: list[int] = []
    keep = Keep(tr["checked_frames"] - 1, seed)
    nonfinite = 0
    before = harness.counters()
    captures0 = (model.frame_graphs.captures if model.frame_graphs else 0,
                 model.grid_graphs.captures if model.grid_graphs else 0)
    harness.settle()

    def feed(t0):
        for t in frame_times(0):
            if time.perf_counter() - t0 >= window:
                return
            b = frame_batch(tr, shared, seed, t)
            taken.append(time.perf_counter())
            times_t.append(t)
            yield b

    with profiled(trace) as holder:
        t0 = time.perf_counter()
        setup_s = time.time() - t_process
        outs = model.render_frames(state, feed(t0), image_shape=(S, S),
                                   session=session, depth=tr["depth"])
        while True:
            with span("render_frames", trace):
                out = next(outs, None)
            if out is None:
                break
            with span("to_host", trace):
                rgba, finite = to_host(out)
            done.append(time.perf_counter())
            n = len(kept)
            kept.append(int(out["n_samples"]))
            keep.offer(times_t[n], rgba, kept[-1])
            nonfinite += not finite
        window_s = time.perf_counter() - t0
    counts = harness.delta(harness.counters(), before)
    captures = ((model.frame_graphs.captures if model.frame_graphs else 0)
                - captures0[0],
                (model.grid_graphs.captures if model.grid_graphs else 0)
                - captures0[1])
    peak = harness.peak(dev)
    hints = list(session.samp_budget.values())
    frame_ms = [1e3 * (d - s) for d, s in zip(done, taken)]
    out = SimpleNamespace(
        notes={"frames": len(done), "window_s": window_s,
               "setup": phase.at,
               "kept_mean": float(np.mean(kept)) if kept else 0.0,
               "samp_hint": max(hints) if hints else None,
               "captures": captures,
               "frame_ms_median": (float(np.median(frame_ms))
                                   if frame_ms else 0.0)},
        kind="frames", setup_s=setup_s, window_s=window_s,
        frames=len(done), attempted=len(taken), failed=nonfinite,
        frame_ms=frame_ms, kept=kept,
        samp_hint=max(hints) if hints else None, captures=captures,
        counters=counts, memory_peak_bytes=peak,
        trace=Traced(holder[0], window_s) if trace else None,
        cfg=cfg, tr=tr, seed=seed, checked=keep.frames(), shared=shared)
    del model, state, session
    harness.free(dev)
    return out


def reference(out, dev, times: list[float], **kw) -> list[np.ndarray]:
    """The reference's frames at ``times``, after the session's first
    frame, as the program's warm-up met it (a pose's grid and bake come
    from the first frame of that pose)."""
    from ..reference import steps
    from ..reference.plain import precision
    model = check.load_reference(out.cfg["name"]).make_model(out.cfg, dev)
    state = model.init(np.zeros((1, 10), np.float32))
    build.load_weights(model.field, build.make_weights(
        out.cfg, build.field_shapes(model.field), out.seed, dev))
    tr = out.tr
    memo: dict = {}
    with precision.lowered() if kw.get("lowered") else nullcontext():
        steps.pose_tables(model, state, frame_batch(
            tr, out.shared, out.seed, tr["warm_start"]), memo)
    return [steps.render_frame(model, state, frame_batch(
        tr, out.shared, out.seed, t), tr["size"], memo, **kw)
        for t in times]


def numbers(out, dev) -> dict:
    """The compared numbers: the kept frames against the reference's."""
    times = [t for _, t, _ in out.checked]
    return check.frame_numbers([f for _, _, f in out.checked],
                               reference(out, dev, times))


def readings(out, dev, controls: bool) -> list[dict]:
    """The program's numbers (the lower reading); with ``controls`` also
    the control's (the reference one precision step down, put in the
    program's place) and ``witness``'s readings."""
    times = [t for _, t, _ in out.checked]
    ref = reference(out, dev, times)
    got = [{"what": "program", **check.frame_numbers(
        [f for _, _, f in out.checked], ref)}]
    if controls:
        got.append({"what": "control", **check.frame_numbers(
            reference(out, dev, times, lowered=True), ref)})
        got.append({"what": "witness", **witness(out, dev, times[-1])})
    return got


def witness(out, dev, t: float) -> dict:
    """Why the reference takes a pose's grid and bake from the session's
    first frame of that pose: frame ``t`` as a session renders it (after
    the warm-up's first frame) against the same frame rendered from
    scratch (its grid and bake built at its own orientation), on the
    program and on the reference; each side's from-scratch frame against
    the other's; and the shell-grid cells in which the two orientations'
    grids differ (the orientation cancels in the world -> SMPL transform
    only up to rounding)."""
    from ..reference import steps
    cfg, tr, S = out.cfg, out.tr, out.tr["size"]
    first = frame_batch(tr, out.shared, out.seed, tr["warm_start"])
    b = frame_batch(tr, out.shared, out.seed, t)
    lib = build.program_lib()
    model = build.make_model(lib, cfg, dev)
    state = model.init(np.zeros((1, 10), np.float32))
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), out.seed, dev))

    def u8(o) -> np.ndarray:
        rgba = torch.cat([o["rgb"].reshape(S, S, 3),
                          o["alpha"].reshape(S, S, 1)], -1)
        return (rgba.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    *_, in_session = (u8(o) for o in model.render_frames(
        state, [first, b], image_shape=(S, S),
        session=lib.train.RenderSession(), depth=1))
    fresh = u8(model.render_frame(state, b, image_shape=(S, S),
                                  session=lib.train.RenderSession()))
    with torch.no_grad():
        cells = int((model.build_pose_grid(state, first, graph=False)
                     .occupancy != model.build_pose_grid(
                         state, b, graph=False).occupancy).sum())
    del model, state
    harness.free(dev)
    ref_session = reference(out, dev, [t])[0]
    rmodel = check.load_reference(cfg["name"]).make_model(cfg, dev)
    rstate = rmodel.init(np.zeros((1, 10), np.float32))
    build.load_weights(rmodel.field, build.make_weights(
        cfg, build.field_shapes(rmodel.field), out.seed, dev))
    ref_fresh = steps.render_frame(rmodel, rstate, b, S, {})
    return {"program_session_vs_fresh": check.rgba_rmse(in_session, fresh),
            "reference_session_vs_fresh": check.rgba_rmse(ref_session,
                                                          ref_fresh),
            "fresh_program_vs_reference": check.rgba_rmse(fresh, ref_fresh),
            "session_program_vs_reference": check.rgba_rmse(in_session,
                                                            ref_session),
            "grid_cells_differ": cells}
