"""Each traffic loop and each reference at a toy size on the CPU, through
the rest of a run (the check for a card skipped): the metrics read, the
program agrees with the reference, and ``correct`` comes out false for
each fault the cell can have: a step that leaves its state unchanged,
half of each batch left out, every step of a group on the group's first
batch, a frame altered where it is produced."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from avatarbench import loops
from avatarbench.loops import frames as frames_loop
from avatarbench.run import cell_metrics, load_json, reader, ROOT

from .conftest import toy_config, toy_traffic

CPU = torch.device("cpu")
MANIFEST = load_json(ROOT / "BENCHMARK.json")


def _run(config: str, traffic: str, trace: bool = False, seconds=0.5,
         seed=2147483659):
    torch.manual_seed(0)
    return loops.load(toy_traffic(traffic)["loop"]).run(
        toy_config(config), toy_traffic(traffic), seed, seconds, trace, CPU,
        time.time())


def _correct(cell: str, numbers: dict) -> bool:
    limits = load_json(ROOT / "avatarbench" / "limits" / f"{cell}.json")
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.fixture(scope="module")
def train_run():
    return _run("snarf-ngp", "train-patch")


@pytest.fixture(scope="module", params=["turntable-540", "animate-540"])
def frames_run(request):
    return request.param, _run("snarf-voxtri", request.param)


def test_train_loop_and_reference_agree(train_run):
    run = train_run
    assert run.steps > 0 and run.failed == 0
    assert reader("train_step_ms")(run) > 0
    assert reader("batch_ms.train")(run) > 0
    nums = loops.load(run.tr["loop"]).numbers(run, CPU)
    # the same plain code on the same device: equal to rounding
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap_median"] < 1e-5
    assert nums["delta_gap"] < 1e-5
    assert _correct("ngp-train", nums)


def test_frames_loop_and_reference_agree(frames_run):
    traffic, run = frames_run
    assert run.frames > 0 and run.failed == 0
    assert reader("render_rays_per_s")(run) > 0
    assert 0 <= reader("stream_padding_pct")(run) < 100
    nums = loops.load(run.tr["loop"]).numbers(run, CPU)
    assert _correct(f"voxtri-{traffic}", nums)


def test_traced_window_reads_every_layer_metric_it_can_on_the_cpu():
    run = _run("snarf-ngp", "train-patch", trace=True)
    assert run.trace is not None and run.trace.window_s > 0
    for m in cell_metrics(MANIFEST, "ngp-train", True):
        value = reader(m["name"])(run)
        # no device activity on the CPU: the device readers find nothing
        assert value is None or value >= 0
    json.dumps(run.trace.idle_gaps()) and json.dumps(run.trace.top_ops())


def test_seeds_change_the_inputs_not_the_sizes():
    tr = toy_traffic("animate-540")
    shared = frames_loop.camera(tr)
    a = frames_loop.frame_batch(tr, shared, 1, 3.0)
    b = frames_loop.frame_batch(tr, shared, 2 ** 31 + 11, 3.0)
    assert a["body_pose"].shape == b["body_pose"].shape
    assert not np.array_equal(a["body_pose"], b["body_pose"])
    assert np.array_equal(
        frames_loop.frame_batch(tr, shared, 1, 3.0)["body_pose"],
        a["body_pose"])


def test_kept_frames_are_drawn_from_the_seed_whatever_the_count():
    """Reservoir sampling: the same seed keeps the same frames; any frame
    of a long window can be drawn; the frame of most samples is kept."""
    def kept(seed, n, most_at):
        keep = frames_loop.Keep(3, seed)
        for i in range(n):
            keep.offer(float(i), np.full((2, 2, 4), i % 256, np.uint8),
                       1000 if i == most_at else i % 7)
        return [i for i, _, _ in keep.frames()]
    a = kept(7, 500, 123)
    assert a == kept(7, 500, 123) and 123 in a and len(a) == 4
    assert kept(8, 500, 123) != a
    drawn = set()
    for seed in range(40):
        drawn.update(kept(seed, 500, 0))
    assert max(drawn) > 250


# -- a whole run with the timed path broken underneath ------------------------

def _measure(cell: str, config: str, traffic: str) -> dict:
    from avatarbench.run import measure
    files = {"cell": {"name": cell, "chips": 1},
             "config": toy_config(config), "traffic": toy_traffic(traffic),
             "limits": load_json(ROOT / "avatarbench" / "limits"
                                 / f"{cell}.json")}
    return measure(MANIFEST, files, cell, 2147483659, 0.5, False, CPU,
                   time.time())


def test_sound_runs_are_correct():
    assert _measure("ngp-train", "snarf-ngp", "train-patch")["correct"]
    assert _measure("voxtri-animate-540", "snarf-voxtri",
                    "animate-540")["correct"]


def test_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from instantavatar_torch.train import optim
    monkeypatch.setattr(optim.GroupedAdam, "step",
                        lambda self: torch.zeros((), dtype=torch.bool))
    res = _measure("ngp-train", "snarf-ngp", "train-patch")
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)
    assert not res["correct"]


def test_half_of_each_batch_left_out_is_not_correct(monkeypatch):
    from instantavatar_torch.train.model import AvatarModel

    from avatarbench.reference.steps import half_batch
    whole = AvatarModel.grads_and_losses

    def half(self, state, batch, draws, *args, **kw):
        return whole(self, state, *half_batch(batch, draws), *args, **kw)
    monkeypatch.setattr(AvatarModel, "grads_and_losses", half)
    assert not _measure("ngp-train", "snarf-ngp", "train-patch")["correct"]


def test_every_step_of_a_group_on_its_first_batch_is_not_correct(
        monkeypatch):
    from instantavatar_torch.train.model import AvatarModel
    grouped = AvatarModel.train_multi_step

    def first_batch(self, state, batches, draws, **kw):
        firsts = {k: v[:1].expand(len(draws), *v.shape[1:])
                  for k, v in batches.items()}
        return grouped(self, state, firsts, draws, **kw)
    monkeypatch.setattr(AvatarModel, "train_multi_step", first_batch)
    res = _measure("ngp-train", "snarf-ngp", "train-patch")
    assert not res["correct"]


@pytest.mark.parametrize("traffic", ["turntable-540", "animate-540"])
def test_frame_altered_where_it_is_produced_is_not_correct(monkeypatch,
                                                           traffic):
    from instantavatar_torch.train.model import AvatarModel
    finish = AvatarModel._finish_frame

    def altered(self, rec):
        out = finish(self, rec)
        rgb = out["rgb"].clone()
        rgb[: rgb.shape[0] // 2] *= 0.5     # the frame's top half darkened
        return {**out, "rgb": rgb}
    monkeypatch.setattr(AvatarModel, "_finish_frame", altered)
    assert not _measure(f"voxtri-{traffic}", "snarf-voxtri",
                        traffic)["correct"]
