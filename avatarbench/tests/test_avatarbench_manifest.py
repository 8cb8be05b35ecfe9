"""BENCHMARK.json against the contract's shape, and every entry resolved
to its files by name."""
from __future__ import annotations

import re

import pytest

from .conftest import BENCH, ROOT, load

MANIFEST = load("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["paths"] == ["avatarbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_entries_keys_and_names():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_and_a_layer():
    e2e, layers = MANIFEST["end_to_end"], MANIFEST["per_layer"]
    e2e_names = {m["name"] for m in e2e}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert "workloads" not in setup  # reported in every cell, later ones too
    for w in cells:
        mine = [m["name"] for m in e2e if w in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in layers)
    for m in layers:
        assert m["moves"] in e2e_names
        moved = next(e for e in e2e if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from avatarbench.run import cell_files, cell_metrics, reader
    files = cell_files(MANIFEST, cell)
    assert files["config"]["name"] == files["cell"]["config"]
    assert (BENCH / "loops" / f"{files['traffic']['loop']}.py").exists()
    assert set(files["limits"])
    assert (BENCH / "reference" / f"{files['cell']['config']}.py").exists()
    for trace in (False, True):
        for m in cell_metrics(MANIFEST, cell, trace):
            assert callable(reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_file_states_its_cut(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    cfg = load(entry["file"])
    assert cfg["name"] == config
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"] and len(cfg["source"]) <= 200
