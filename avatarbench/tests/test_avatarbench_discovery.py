"""A configuration, a traffic mix, a limits file, a per-layer metric and a
new kind of loop dropped into a copy of the benchmark are found by name,
with no edit of any file that was there: only new files and new
BENCHMARK.json entries. A configuration names its parts' classes, so a
part of another class needs no edit either."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from .conftest import BENCH, ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "avatarbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "avatarbench").rglob("*") if p.is_file()}
    b = tmp_path / "avatarbench"
    cfg = json.loads((b / "configs" / "snarf-ngp.json").read_text())
    cfg["name"] = "snarf-ngp-copy"
    (b / "configs" / "snarf-ngp-copy.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference" / "snarf-ngp.py",
                b / "reference" / "snarf-ngp-copy.py")
    tr = json.loads((b / "traffic" / "train-patch.json").read_text())
    tr["frames"] = 57
    (b / "traffic" / "train-half.json").write_text(json.dumps(tr))
    (b / "limits" / "copy-train.json").write_text(
        json.dumps({"loss_gap": 0.5}))
    (b / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    manifest["configs"].append({
        "name": "snarf-ngp-copy", "source": "a test",
        "file": "avatarbench/configs/snarf-ngp-copy.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "copy-train", "config": "snarf-ngp-copy",
        "traffic": "train-half", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("copy-train")
    manifest["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "training step",
        "moves": "train_step_ms", "workloads": ["copy-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    probe = """
import json
from types import SimpleNamespace
from avatarbench.run import cell_files, cell_metrics, load_json, reader, ROOT
from avatarbench.check import load_reference
m = load_json(ROOT / "BENCHMARK.json")
f = cell_files(m, "copy-train")
names = [x["name"] for x in cell_metrics(m, "copy-train", True)]
value = reader("steps_seen.train")(SimpleNamespace(steps=3))
print(json.dumps({"config": f["config"]["name"],
                  "frames": f["traffic"]["frames"], "limits": f["limits"],
                  "layer": names, "value": value,
                  "ref": hasattr(load_reference("snarf-ngp-copy"),
                                 "make_model")}))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "snarf-ngp-copy", "frames": 57,
                   "limits": {"loss_gap": 0.5},
                   "layer": ["steps_seen.train"], "value": 3.0, "ref": True}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "avatarbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


LOOP = '''"""A loop of another kind: it times a sum of the seed's numbers and
compares it with numpy's."""
import time
from types import SimpleNamespace

import numpy as np
import torch

from avatarbench import build


def run(cfg, tr, seed, seconds, trace, dev, t_process):
    body = build.make_body(build.reference_lib(), cfg, dev)
    x = torch.rand(tr["rows"], generator=torch.Generator().manual_seed(seed))
    t0, sums = time.perf_counter(), 0
    while time.perf_counter() - t0 < min(seconds, 0.2):
        got = float(x.sum())
        sums += 1
    return SimpleNamespace(
        kind="sum", notes={}, setup_s=0.1, window_s=time.perf_counter() - t0,
        steps=sums, attempted=sums, failed=0, memory_peak_bytes=0,
        trace=None, cfg=cfg, tr=tr, seed=seed, got=got, x=x.numpy(),
        vertices=int(body.v_template.shape[0]))


def numbers(out, dev):
    return {"sum_gap": abs(out.got - float(np.sum(out.x, dtype=np.float64)))}


def readings(out, dev, controls):
    return [{"what": "program", **numbers(out, dev)}]
'''


def test_a_new_kind_of_loop_and_part_need_no_edit(tmp_path):
    """A loop module, a traffic file naming it, a configuration naming a
    body of other sizes, a cell, limits and a metric: a whole run of the
    new cell (the look for a card skipped) gives a correct result line."""
    shutil.copytree(BENCH, tmp_path / "avatarbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "avatarbench").rglob("*") if p.is_file()}
    b = tmp_path / "avatarbench"
    (b / "loops" / "sum.py").write_text(LOOP)
    (b / "traffic" / "sum-1k.json").write_text(
        json.dumps({"loop": "sum", "rows": 1000}))
    (b / "configs" / "toy-body.json").write_text(json.dumps({
        "name": "toy-body", "source": "a test", "reduced": [],
        "assumed": {"body": "a test"},
        "body": {"class": "toy_smpl_model", "ring_size": 4, "seed": 1}}))
    (b / "limits" / "sum-cell.json").write_text(json.dumps({"sum_gap": 1e-2}))
    (b / "metrics" / "sums_per_s.py").write_text(
        "def read(run):\n    return run.steps / run.window_s\n")
    (b / "metrics" / "vertices.sum.py").write_text(
        "def read(run):\n    return float(run.vertices)\n")
    manifest["configs"].append({
        "name": "toy-body", "source": "a test",
        "file": "avatarbench/configs/toy-body.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "sum-cell", "config": "toy-body", "traffic": "sum-1k",
        "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({
        "name": "sums_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": ["sum-cell"]})
    manifest["per_layer"].append({
        "name": "vertices.sum", "unit": "vertices", "better": "higher",
        "source": "program_counter", "layer": "body",
        "moves": "sums_per_s", "workloads": ["sum-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    probe = """
import json, time
import torch
from avatarbench.run import cell_files, load_json, measure, ROOT
m = load_json(ROOT / "BENCHMARK.json")
res = {}
for trace in (False, True):
    res[trace] = measure(m, cell_files(m, "sum-cell"), "sum-cell",
                         2147483659, 0.2, trace, torch.device("cpu"),
                         time.time())
print(json.dumps({"e2e": res[False], "layer": res[True]}))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    e2e, layer = got["e2e"], got["layer"]
    assert e2e["correct"] and e2e["attempted"] > 0
    assert set(e2e["metrics"]) == {"sums_per_s", "setup_s"}
    assert layer["metrics"]["vertices.sum"]["value"] == 24 * 4
    assert list(e2e)[-1] == "checks"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "avatarbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run prints no result and exits non-zero."""
    shutil.copytree(BENCH, tmp_path / "avatarbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "avatarbench.run", "--workload", "ngp-train",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
