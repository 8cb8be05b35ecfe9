"""The traffic generator's loops, one file per kind of work, found by the
name that a traffic file gives under ``"loop"``: ``loops/<name>.py``.

Each loop module has ``run(cfg, tr, seed, seconds, trace, dev,
t_process)``, which sets up, drives the window and returns the run's
record (what the readers in ``metrics/`` take); ``numbers(run, dev)``,
the numbers compared with the plain reference once the window has
closed; and ``readings(run, dev, controls)``, the readings that the
limits are set from (``calibrate.py``). A new kind of work is a new file
here, with no edit of any other.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

__all__ = ["load"]


def load(name: str):
    """``loops/<name>.py`` as the module ``avatarbench.loops.<name>``."""
    full = f"{__name__}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no loop {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod
