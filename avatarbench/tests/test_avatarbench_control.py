"""The control: the reference put in the program's place, computed one
precision step below the configuration's (TF32 operands for the fp32
MLPs of ``snarf-ngp``, fp8 e4m3 operands for the bf16 head of
``snarf-voxtri``), must come out as not correct. At a toy size on the
CPU, and on the card at each cell's own size on three seeds."""
from __future__ import annotations

import time

import pytest
import torch

from avatarbench import calibrate, loops
from avatarbench.run import cell_files, load_json, ROOT

from .conftest import toy_config, toy_traffic

MANIFEST = load_json(ROOT / "BENCHMARK.json")
CELLS = [("ngp-train", "snarf-ngp", "train-patch"),
         ("voxtri-turntable-540", "snarf-voxtri", "turntable-540"),
         ("voxtri-animate-540", "snarf-voxtri", "animate-540")]


def _fails(cell: str, numbers: dict) -> bool:
    limits = load_json(ROOT / "avatarbench" / "limits" / f"{cell}.json")
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_control_is_not_correct_at_a_toy_size(cell, config, traffic):
    cpu = torch.device("cpu")
    loop = loops.load(toy_traffic(traffic)["loop"])
    run = loop.run(toy_config(config), toy_traffic(traffic), 2147483671, 0.5,
                   False, cpu, time.time())
    got = {r["what"]: r for r in loop.readings(run, cpu, True)}
    assert not _fails(cell, got["program"])
    assert _fails(cell, got["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_control_is_not_correct_at_the_cells_size(cuda_device, cell):
    files = cell_files(MANIFEST, cell)
    for seed in (3300000001, 3300000002, 3300000003):
        control = [r for r in calibrate.readings(files, seed, 1.0,
                                                 cuda_device, True)
                   if r["what"] == "control"]
        assert control and _fails(cell, control[0])
