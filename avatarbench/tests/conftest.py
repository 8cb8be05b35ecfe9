"""Toy-sized configurations and traffic for the benchmark's own tests, and
the fixture that skips a card test without a card (decided when the test
runs, never at import)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def toy_config(name: str) -> dict:
    """A configuration cut to a size that runs in seconds on the CPU."""
    cfg = load(f"avatarbench/configs/{name}.json")
    cfg["body"].update(ring_size=8, bone_rings=0)
    cfg["deformer"].update(resolution=16)
    cfg["avatar"].update(grid_size=16)
    if "grid" in cfg["field"]:
        cfg["field"]["grid"].update(n_levels=4, log2_hashmap_size=12)
        cfg["widths"]["sigma_dims"] = [8, 64, 16]
        cfg["avatar"].update(n_steps=32, k_cap=8)
    else:
        cfg["field"].update(voxel_res=8, plane_res=16)
    return cfg


def toy_traffic(name: str) -> dict:
    tr = load(f"avatarbench/traffic/{name}.json")
    if tr["loop"] == "train":
        tr.update(frames=6, size=48, focal=48.0, num_patch=2, patch_size=8,
                  warm_steps=[0, 1], trace_seconds=0.5)
    else:
        tr.update(size=48, focal=1000.0 * 48 / 540, warm_frames=3,
                  checked_frames=2, trace_seconds=0.5)
    return tr


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "`python -m pytest avatarbench/tests -q -m cuda`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
