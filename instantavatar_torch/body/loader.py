"""SMPL asset loading.

Port of ``instantavatar_tpu/body/loader.py``: the standard
``SMPL_{GENDER}.pkl`` releases (chumpy arrays and a scipy sparse
regressor, read without chumpy through a stub unpickler) or a converted
``.npz``, into the port's ``SMPLModel`` on one device. The files are
license-gated and not in the repository.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from .smpl import SMPLModel

__all__ = ["load_smpl_model", "find_model_file"]

NUM_BETAS = 10


class _ChumpyStub:
    """Captures pickled chumpy object state; exposes the wrapped ndarray."""

    def __init__(self, *args, **kwargs):
        self._state = None

    def __setstate__(self, state):
        self._state = state

    def to_array(self):
        state = self._state
        if isinstance(state, dict):
            for key in ("x", "a", "v", "_data"):
                if key in state and isinstance(state[key], np.ndarray):
                    return state[key]
            for v in state.values():
                if isinstance(v, np.ndarray):
                    return v
                if isinstance(v, _ChumpyStub):
                    arr = v.to_array()
                    if arr is not None:
                        return arr
        return None


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _as_array(obj) -> np.ndarray:
    if isinstance(obj, _ChumpyStub):
        arr = obj.to_array()
        if arr is None:
            raise ValueError("could not extract array from chumpy object")
        return np.asarray(arr)
    if hasattr(obj, "toarray"):  # scipy sparse (J_regressor)
        return np.asarray(obj.toarray())
    return np.asarray(obj)


def find_model_file(model_path: str | Path, gender: str = "neutral") -> Path:
    """Resolve a model file: a direct file path, or a dir holding
    SMPL_{GENDER}.pkl / .npz (case-insensitive gender)."""
    p = Path(model_path)
    if p.is_file():
        return p
    gender = gender.upper()
    for name in (f"SMPL_{gender}.pkl", f"SMPL_{gender}.npz",
                 f"smpl/SMPL_{gender}.pkl", f"smpl/SMPL_{gender}.npz",
                 f"SMPL_{gender.lower()}.pkl"):
        cand = p / name
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"no SMPL model for gender={gender!r} under {model_path!r}")


def load_smpl_model(model_path: str | Path, gender: str = "neutral",
                    num_betas: int = NUM_BETAS, *,
                    device: torch.device | str) -> SMPLModel:
    """Load an SMPL release (``.pkl`` or ``.npz``) onto ``device``. The
    pickles are the official SMPL files, which need the stub unpickler;
    load only files from that source."""
    path = find_model_file(model_path, gender)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=True) as data:
            raw = {k: data[k] for k in data.files}
    else:
        with open(path, "rb") as f:
            raw = _StubUnpickler(f, encoding="latin1").load()

    shapedirs = _as_array(raw["shapedirs"]).astype(np.float32)[..., :num_betas]
    posedirs = _as_array(raw["posedirs"]).astype(np.float32)
    if posedirs.ndim == 3:  # (V, 3, 207) -> (207, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = _as_array(raw["kintree_table"])[0].astype(np.int64)
    parents[0] = -1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    return SMPLModel(
        v_template=t(_as_array(raw["v_template"])),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        J_regressor=t(_as_array(raw["J_regressor"])),
        lbs_weights=t(_as_array(raw["weights"])),
        parents=parents,
        faces=_as_array(raw.get("f", raw.get("faces"))).astype(np.int64))
