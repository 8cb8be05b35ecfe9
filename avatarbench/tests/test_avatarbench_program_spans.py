"""The program's spans as the benchmark reads them: the eight readers on
a synthetic traced window (each in its cells, None outside them, on an
untraced run and on a program without spans); ``program_spans.join`` on
a synthetic window whose program clock is off the trace's by a known
amount (the offset recovered, every outermost span inside its harness
span, the idle time put down to the right spans); and a toy traced
window of each kind of loop on the CPU, in which every new metric of the
cell that the CPU can give reports and the join holds every span."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from avatarbench import loops, program_spans
from avatarbench.run import cell_metrics, load_json, reader, ROOT

from .conftest import toy_config, toy_traffic

MANIFEST = load_json(ROOT / "BENCHMARK.json")
NEW = {"frame_host_ms.render": "frames", "count_wait_ms.render": "frames",
       "rerender_pct.render": "frames", "pose_grid_ms.render": "frames",
       "idle_in_program_pct.render": "frames",
       "step_host_ms.train": "train", "dataset_ms.train": "train",
       "idle_in_program_pct.train": "train"}
OFF = 1_234_567.891   # trace clock - program clock, us
N = 8                  # frames, or steps


def _profiling():
    from instantavatar_torch.utils import profiling
    return profiling


class _Rec:
    """Synthetic program spans, given on the trace's clock (us)."""

    def __init__(self):
        self.spans, self.device_ms, self.stack = [], {}, []

    def open(self, name, start, end, rid=None, tag=None, device_ms=None):
        Span = _profiling().Span
        parent = None
        while self.stack and self.stack[-1][1] < end:
            self.stack.pop()
        if self.stack:
            parent = self.stack[-1][0]
        i = len(self.spans)
        self.spans.append(Span(i, parent, name, rid, tag,
                               round((start - OFF) * 1e3),
                               round((end - OFF) * 1e3), None))
        if device_ms is not None:
            self.device_ms[i] = device_ms
        self.stack.append((i, end))


def _install(monkeypatch, rec: _Rec, counts: dict) -> None:
    r = _profiling()._REC
    monkeypatch.setattr(r, "spans", sorted(rec.spans, key=lambda s: s[6]))
    monkeypatch.setattr(r, "device_ms", rec.device_ms)
    monkeypatch.setattr(r, "counts", counts)
    monkeypatch.setattr(r, "overflow", 0)


def _frames_window(monkeypatch, grid=True):
    """N frames, one ``render_frames`` call each (c0 .. c0 + 20 ms, then
    ``to_host``); the device busy on the grid (2.0-2.6 ms) and the frame
    (9-19 ms); frame 3 re-rendered once. Each finish closes 5-9 us before
    its call returns."""
    rec, harness, busy = _Rec(), [], []
    for i in range(N):
        c0 = 100.0 + 30_000.0 * i
        c1 = c0 + 20_000.0
        harness += [(c0, c1, "render_frames"),
                    (c1 + 50, c1 + 2000, "to_host")]
        busy += [[c0 + 2000, c0 + 2600], [c0 + 9000, c0 + 19_000]]
        rec.open("frame.enqueue", c0 + 300, c0 + 12_000, i)
        rec.open("frame.key", c0 + 300, c0 + 500, i)
        if grid:
            rec.open("grid.build", c0 + 500, c0 + 3000, i)
            rec.open("grid.replay", c0 + 2000, c0 + 2500, i,
                     "smpl_shell", device_ms=0.5)
        rec.open("frame.dispatch", c0 + 3000, c0 + 11_900, i, "first")
        rec.open("frame.finish", c0 + 12_050, c1 - 5 - i % 5, i)
        if i == 3:
            rec.open("frame.dispatch", c0 + 12_060, c0 + 12_090, i,
                     "rerender")
        rec.open("frame.wait", c0 + 12_100, c0 + 19_900, i)
    _install(monkeypatch, rec, {"frame.rerenders": 1})
    return SimpleNamespace(kind="frames", trace=SimpleNamespace(
        spans=harness, merged=busy))


def _train_window(monkeypatch):
    """N steps: per step a ``batch`` span holding its ``data.item``
    (0.4 ms) and a ``train_multi_step`` call of one ``step.run`` (closing
    5-7 us before the call returns; its replay 0.3 ms); the device busy
    5 ms behind each replay."""
    rec, harness, busy = _Rec(), [], []
    for i in range(N):
        c0 = 100.0 + 10_000.0 * i
        harness += [(c0, c0 + 500, "batch"),
                    (c0 + 600, c0 + 1700, "train_multi_step")]
        busy.append([c0 + 1200, c0 + 6200])
        rec.open("data.item", c0 + 50, c0 + 450, i)
        rec.open("step.run", c0 + 610, c0 + 1695 - i % 3, i)
        rec.open("step.replay", c0 + 1000, c0 + 1300, i, "plain",
                 device_ms=5.0)
    _install(monkeypatch, rec, {})
    return SimpleNamespace(kind="train", trace=SimpleNamespace(
        spans=harness, merged=busy))


def test_every_new_metric_is_in_the_manifest_for_its_cells():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    for name, kind in NEW.items():
        entry = next(m for m in MANIFEST["per_layer"] if m["name"] == name)
        for cell in entry["workloads"]:
            traffic = load_json(ROOT / "avatarbench" / "traffic"
                                / f"{cells[cell]['traffic']}.json")
            assert traffic["loop"] == kind, (name, cell)
    pose = next(m for m in MANIFEST["per_layer"]
                if m["name"] == "pose_grid_ms.render")
    assert pose["workloads"] == ["voxtri-animate-540"]


def test_readers_on_a_synthetic_frames_window(monkeypatch):
    run = _frames_window(monkeypatch)
    assert reader("frame_host_ms.render")(run) == pytest.approx(
        (N * 11.7 + 0.03) / N)
    assert reader("count_wait_ms.render")(run) == pytest.approx(7.8)
    assert reader("rerender_pct.render")(run) == pytest.approx(100.0 / N)
    assert reader("pose_grid_ms.render")(run) == pytest.approx(0.5)
    # idle a frame: 9,100 us less the finish's end delay (5-9 us) in
    # program spans, of 19,400 us (the last frame's 8,000 after its
    # to_host are past the window)
    pct = reader("idle_in_program_pct.render")(run)
    want = (100.0 * sum(9100 - 5 - i % 5 for i in range(N))
            / (N * 19_400 - 8000))
    assert pct == pytest.approx(want, rel=1e-9)
    # a turntable's window builds no grid: no pose-grid reading
    run = _frames_window(monkeypatch, grid=False)
    assert reader("pose_grid_ms.render")(run) is None


def test_readers_on_a_synthetic_train_window(monkeypatch):
    run = _train_window(monkeypatch)
    assert reader("step_host_ms.train")(run) == pytest.approx(
        (N * 0.785 - sum(i % 3 for i in range(N)) / 1e3) / N)
    assert reader("dataset_ms.train")(run) == pytest.approx(0.4)
    # idle a step: 5,000 us (the last step's 3,800 after its call are
    # past the window), 985 of it in program spans: data.item's 400 and
    # step.run's from its start (615 us in, the fit's 5 us included) to
    # the device's (1,200)
    pct = reader("idle_in_program_pct.train")(run)
    assert pct == pytest.approx(100.0 * N * 985 / (N * 5000 - 3800),
                                rel=1e-9)
    assert program_spans.join(run)["inside_pct"] == 100.0


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_give_nothing_outside_their_cells(monkeypatch, name):
    """Outside its kind of loop, on an untraced run, on a program
    without spans, and with no span of its own in the window: None."""
    read = reader(name)
    kind = NEW[name]
    other = "train" if kind == "frames" else "frames"
    run = (_frames_window if kind == "frames" else _train_window)(
        monkeypatch)
    assert read(run) is not None
    assert read(SimpleNamespace(**{**vars(run), "kind": other})) is None
    assert read(SimpleNamespace(**{**vars(run), "kind": "sum"})) is None
    assert read(SimpleNamespace(**{**vars(run), "trace": None})) is None
    with monkeypatch.context() as m:
        m.setattr(program_spans, "_profiling", lambda: None)
        assert read(run) is None
    _install(monkeypatch, _Rec(), {})
    assert read(run) is None


def test_join_recovers_a_known_offset(monkeypatch):
    """The fit puts the program's spans within the least end delay
    (5 us) of the known offset, with no spread across the window's
    quarters but that delay's; every outermost span falls inside its
    harness span; the idle time goes to the spans it overlaps."""
    run = _frames_window(monkeypatch)
    j = program_spans.join(run)
    assert j["offset_us"] == pytest.approx(OFF + 5.0, abs=1e-3)
    assert j["offset_spread_us"] <= 4.0 + 1e-3 and j["calls"] == N
    assert j["inside_pct"] == 100.0
    by = j["idle_by_span_ms"]
    assert by["frame.dispatch"] == pytest.approx(N * 6.0, abs=N * 0.01)
    assert by["frame.key"] == pytest.approx(N * 0.2, abs=N * 0.01)
    assert by["grid.build"] == pytest.approx(N * 1.9, abs=N * 0.01)
    assert by["frame.wait"] == pytest.approx(N * 0.9, abs=N * 0.01)
    assert by["harness.to_host"] == pytest.approx(N * 1.95, abs=N * 0.01)
    assert sum(by.values()) == pytest.approx(j["idle_ms"])
    assert j["longest_gaps_ms"][0] == [program_spans.OUTSIDE,
                                       pytest.approx(13.0)]
    # a program clock 40 ms later: the same fit, moved
    moved = [s._replace(start_ns=s.start_ns - 40_000_000,
                        end_ns=s.end_ns - 40_000_000)
             for s in _profiling()._REC.spans]
    monkeypatch.setattr(_profiling()._REC, "spans", moved)
    assert program_spans.join(run)["offset_us"] == pytest.approx(
        OFF + 40_005.0, abs=1e-3)


def test_the_fit_survives_a_late_first_span():
    """The first span opening late in its call (a slow first batch)
    still puts the short last span of the last call in that call."""
    calls = [(0.0, 5000.0), (5100.0, 9000.0), (9100.0, 9160.0)]
    tops = [(1500.0, 4000.0), (4010.0, 4990.0), (5200.0, 8900.0),
            (8910.0, 8995.0), (9120.0, 9150.0)]
    got = program_spans.fit_offset(calls, tops)
    assert got["offset_us"] == pytest.approx(5.0) and got["calls"] == 3


@pytest.mark.parametrize("cell,config,traffic", [
    ("ngp-train", "snarf-ngp", "train-patch"),
    ("voxtri-turntable-540", "snarf-voxtri", "turntable-540")])
def test_a_toy_traced_window_reports_the_new_metrics(cell, config, traffic):
    """A traced toy window on the CPU: each new metric of the cell that
    needs no device reports (the pose grid's device time and the device
    metrics need the card; there is no device activity here), and every
    outermost program span lies inside a harness span."""
    _profiling().reset()
    run = loops.load(toy_traffic(traffic)["loop"]).run(
        toy_config(config), toy_traffic(traffic), 2147483659, 0.5, True,
        torch.device("cpu"), time.time())
    names = {m["name"] for m in cell_metrics(MANIFEST, cell, True)}
    for name in set(NEW) & names:
        value = reader(name)(run)
        assert value is not None and value >= 0, name
    assert program_spans.join(run)["inside_pct"] == 100.0
