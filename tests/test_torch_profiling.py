"""The port's spans and counters (``instantavatar_torch/utils/profiling.py``)
on the CPU: with tracing off they record nothing and call nothing into
torch's profiler or CUDA; inside a ``torch.profiler`` session a toy
``render_frames`` records each frame's enqueue, dispatch and finish with
its sequence number and parents, and ``train_multi_step`` on
``FrameDataset`` batches records each step and each dataset item; the
summary's self times add up to the parent's, and its tail over requests
sums each request's re-entries; the buffer's overflow is counted;
``trace`` writes ``spans.json`` and puts the spans into
``trace.json``. The frames run eagerly here, so there is no replay span
(the card's test of the spans around captures is in
tests/test_torch_cuda.py)."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instantavatar_torch import convert
from instantavatar_torch.body import toy_smpl_model
from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                      make_capsule_sequence)
from instantavatar_torch.data.rays import make_ray_basis
from instantavatar_torch.deformers import SNARFDeformer
from instantavatar_torch.models import VoxelTriplaneField
from instantavatar_torch.train import AvatarModel, RenderSession
from instantavatar_torch.utils import profiling

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

H = 24


@pytest.fixture(scope="module")
def scene():
    """A small opaque voxel-triplane avatar (SNARF res 16, grid 16), a
    24 px turntable of 3 views, and a train split of 3 capsule frames."""
    body = toy_smpl_model(bone_rings=3, device="cpu")
    field = VoxelTriplaneField(voxel_res=8, plane_res=16, device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(8, 16, 3, sigma_bias=100.0)))
    av = AvatarModel(body, field, SNARFDeformer(
        body, resolution=16, cano_pose="a_pose", n_iters=6, cand_cap=2,
        n_init_active=4), n_steps=32, k_cap=8, grid_size=16,
        cache_n_cand=1, eval_grid="smpl_shell", shell_margin=0.08)
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    b = {"ray_basis": make_ray_basis(K, np.eye(4)),
         "betas": np.zeros(10, np.float32),
         "body_pose": np.zeros(69, np.float32),
         "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    frames = [{**b, "global_orient": np.array([0.0, y, 0.0], np.float32)}
              for y in (0.0, 0.4, 0.8)]
    seq = make_capsule_sequence(3, H, H, bone_rings=2, device="cpu")
    ds = FrameDataset(seq["images"], seq["masks"], seq["K"], seq["c2w"],
                      seq["smpl_params"], "train",
                      sampler=PatchSampler(1, 8, ratio_mask=1.0,
                                           rng=np.random.default_rng(1)),
                      bg_rng=np.random.default_rng(2))
    return {"avatar": av, "frames": frames, "dataset": ds,
            "betas": seq["smpl_params"]["betas"]}


def _render(scene):
    av = scene["avatar"]
    state = av.init(np.zeros(10, np.float32))
    return list(av.render_frames(state, scene["frames"], image_shape=(H, H),
                                 session=RenderSession()))


def _train(scene, steps=2):
    """``steps`` steps in one ``train_multi_step`` call, on a group that
    ``FrameDataset`` assembles."""
    av = scene["avatar"]
    state = av.init(scene["betas"])
    items = [scene["dataset"][i] for i in range(steps)]
    batch = {k: np.stack([np.asarray(it[k]) for it in items])
             for k in items[0]}
    n = int(np.prod(batch["rays_o"].shape[1:-1]))
    gen = torch.Generator().manual_seed(0)
    return av.train_multi_step(state, batch,
                               av.draw_steps(gen, n, state.step, steps))


def _profiled(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.records()


def test_the_switch_is_the_profilers_module_flag():
    """Tracing is on exactly while a profiler session runs, as the
    profiler's module bool says."""
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert profiling.span("x") is not profiling.span("y")
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.span("x") is profiling.span("y")   # the one no-op


def test_tracing_off_records_nothing_and_calls_no_torch(scene, monkeypatch):
    """With no profiler running, frames and steps through every spanned
    path record no span and no count, and open no ``record_function``,
    CUDA event or profiler call."""
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")
    for mod, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch.cuda, "Event"),
                      (torch.cuda, "is_current_stream_capturing"),
                      (torch.cuda, "is_initialized"),
                      (torch.cuda, "synchronize")):
        monkeypatch.setattr(mod, name, refuse)
    profiling.reset()
    with profiling.span("outer", 1, "t", device=True):
        profiling.count("c", 3)
    assert len(_render(scene)) == 3
    _train(scene)
    monkeypatch.undo()
    s = profiling.summary()
    assert profiling.records() == [] and s["spans"] == {}
    assert s["counters"] == {} and s["overflow"] == 0


def test_render_frames_records_frame_spans(scene):
    """Three frames, two in flight: each frame's ``frame.enqueue`` (the
    frame key, the grid, the dispatch and its bake plan inside),
    ``frame.finish`` (``frame.wait`` and any re-render's dispatch inside)
    carry the frame's sequence number, their children the parent's; the
    first frame builds the grid, the turntable's later ones reuse it; no
    replay span on the CPU."""
    outs, recs = _profiled(lambda: _render(scene))
    assert len(outs) == 3
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert {"frame.enqueue", "frame.key", "grid.build", "frame.dispatch",
            "frame.bake_plan", "frame.finish", "frame.wait"} <= names
    assert not {"frame.replay", "grid.replay", "step.run"} & names
    for top in ("frame.enqueue", "frame.finish"):
        got = [r for r in recs if r.name == top]
        assert sorted(r.rid for r in got) == [0, 1, 2]
        assert all(r.parent is None for r in got)
    for r in recs:
        parent = by_id.get(r.parent)
        if r.name in ("frame.key", "grid.build"):
            assert parent.name == "frame.enqueue" and r.rid == parent.rid
        if r.name == "frame.dispatch":
            assert parent.name == ("frame.enqueue" if r.tag == "first"
                                   else "frame.finish")
            assert r.rid == parent.rid
        if r.name == "frame.bake_plan":
            assert parent.name == "frame.dispatch" and r.rid == parent.rid
        if r.name == "frame.wait":
            assert parent.name == "frame.finish" and r.rid == parent.rid
        assert r.start_ns <= r.end_ns
        if parent is not None:
            assert parent.start_ns <= r.start_ns <= r.end_ns \
                <= parent.end_ns
    s = profiling.summary()
    first = s["spans"]["frame.dispatch"]["tags"]["first"]["count"]
    assert first == 3
    rerenders = s["counters"].get("frame.rerenders", 0)
    assert s["spans"]["frame.dispatch"]["count"] == 3 + rerenders
    # the first frame builds the pose's grid; the later views take it
    grid = sorted((r.end_ns - r.start_ns, r.rid) for r in recs
                  if r.name == "grid.build")
    assert grid[-1][1] == 0
    # of three frames the tail over requests is the slowest frame's
    waits = {}
    for r in recs:
        if r.name == "frame.wait":
            waits[r.rid] = waits.get(r.rid, 0) + r.end_ns - r.start_ns
    assert s["spans"]["frame.wait"]["rid_p95_ms"] == pytest.approx(
        max(waits.values()) / 1e6)


def test_train_multi_step_records_step_and_data_spans(scene):
    """Two steps in one call on a group of two ``FrameDataset`` items:
    ``data.item`` per item (no request id: an item serves no one frame or
    step), ``step.run`` per step with the step's ``state.step``; no
    replay or capture span on the CPU."""
    (state, losses), recs = _profiled(lambda: _train(scene))
    assert state.step == 2 and torch.isfinite(losses["loss"])
    items = [r for r in recs if r.name == "data.item"]
    steps = [r for r in recs if r.name == "step.run"]
    assert len(items) == 2 and all(r.rid is None for r in items)
    assert [r.rid for r in steps] == [0, 1]
    assert all(r.parent is None for r in items + steps)
    assert not {r.name for r in recs} & {"step.replay", "step.capture"}


def test_summary_self_times_add_up(scene):
    """Every span's host ms is its self ms plus its children's host ms;
    the parents' totals in the summary are so too."""
    _profiled(lambda: _render(scene))
    recs = profiling.records()
    kids = {}
    for r in recs:
        if r.parent is not None:
            kids[r.parent] = kids.get(r.parent, 0) + r.end_ns - r.start_ns
    s = profiling.summary()["spans"]
    total_self = sum(e["self_ms"] for e in s.values())
    tops = sum(e["host_ms"] for n, e in s.items()
               if n in ("frame.enqueue", "frame.finish"))
    assert total_self == pytest.approx(tops, rel=1e-9)
    enq = s["frame.enqueue"]
    children = sum(e["host_ms"] for n, e in s.items()
                   if n in ("frame.key", "grid.build"))
    children += s["frame.dispatch"]["tags"]["first"]["host_ms"]
    assert enq["self_ms"] + children == pytest.approx(enq["host_ms"],
                                                      rel=1e-9)
    for r in recs:
        own = r.end_ns - r.start_ns - kids.get(r.id, 0)
        assert own >= 0


def test_summary_tail_over_requests(monkeypatch):
    """``rid_p95_ms`` is the nearest-rank 95th percentile over request
    ids of one request's host ms in a span, its re-entries summed and its
    children taking its id; None for spans without one."""
    t = iter(range(0, 10 ** 9, 10 ** 6))          # 1 ms a clock read
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(profiling.time, "perf_counter_ns",
                            lambda: next(t))
        for rid in range(20):
            with profiling.span("frame", rid):     # 1 ms
                pass
        for _ in range(3):                         # frame 19: 1 + 3 x 3 ms
            with profiling.span("frame", 19):
                with profiling.span("wait"):       # 1 ms each, rid 19
                    pass
        with profiling.span("loose"):
            pass
        monkeypatch.undo()
    s = profiling.summary()["spans"]
    # 19 requests of 1 ms and one of 10: the 19th of 20 sorted is 1 ms
    assert s["frame"]["rid_p95_ms"] == pytest.approx(1.0)
    assert s["frame"]["host_ms"] == pytest.approx(29.0)
    assert s["wait"]["rid_p95_ms"] == pytest.approx(3.0)
    assert s["loose"]["rid_p95_ms"] is None


def test_overflow_is_counted(monkeypatch):
    """Spans beyond the buffer's capacity are dropped and counted; the
    counters go on counting."""
    monkeypatch.setattr(profiling._REC, "capacity", 5)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(8):
            with profiling.span("s", i):
                profiling.count("n")
    s = profiling.summary()
    assert s["spans"]["s"]["count"] == 5 and s["overflow"] == 3
    assert s["counters"]["n"] == 8
    assert [r.rid for r in profiling.records()] == [0, 1, 2, 3, 4]


def test_trace_writes_spans_json_and_names_spans_in_trace_json(scene,
                                                               tmp_path):
    """``trace`` mirrors each span as a ``record_function`` range, so the
    Chrome trace names them, and writes the block's summary."""
    with profiling.trace(tmp_path / "p"):
        _render(scene)
    text = (tmp_path / "p" / "trace.json").read_text()
    for name in ("frame.enqueue", "frame.dispatch", "frame.finish",
                 "frame.wait"):
        assert f'"{name}"' in text, name
    spans = json.loads((tmp_path / "p" / "spans.json").read_text())
    assert spans["spans"]["frame.finish"]["count"] == 3
    assert spans == json.loads(json.dumps(profiling.summary()))
    # outside trace, spans are not mirrored
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("plain"):
            pass
    assert "plain" not in {e.name for e in prof.events()}
    assert profiling.summary()["spans"]["plain"]["count"] == 1
