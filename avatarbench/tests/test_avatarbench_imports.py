"""No module that a run or the reference imports has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``instantavatar_tpu``, and none that the
reference imports is ``instantavatar_torch``: top-level names compared
whole (``instantavatar_torch`` begins with the JAX package's name)."""
from __future__ import annotations

import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "instantavatar_tpu"}


def _loaded_after(code: str) -> set[str]:
    probe = code + """
import json, sys
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    loaded = _loaded_after(
        "import avatarbench.run, avatarbench.check\n"
        "from avatarbench import loops; loops.load('train'); "
        "loops.load('frames')\n"
        "import avatarbench.build as b; b.program_lib()\n"
        "import instantavatar_torch.data, instantavatar_torch.kernels\n")
    assert "instantavatar_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after(
        "from avatarbench.check import load_reference\n"
        "import avatarbench.reference.steps, avatarbench.synth\n"
        "for c in ('snarf-ngp', 'snarf-voxtri'):\n"
        "    load_reference(c)\n")
    assert "avatarbench" in loaded
    assert not loaded & (FORBIDDEN | {"instantavatar_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    from avatarbench import run
    monkeypatch.setitem(sys.modules, "instantavatar_tpu_like", sys)
    assert "instantavatar_tpu_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()
