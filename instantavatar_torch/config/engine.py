"""Hydra-compatible configuration engine.

Port of ``instantavatar_tpu/config/engine.py``: the same composition of the
repo's ``confs/`` tree (``defaults`` lists, group overrides, ``+key=``,
``${...}`` interpolation) and ``instantiate``, with the YAML read and
written by ``yaml_lite`` (the port does not depend on PyYAML).
``_target_`` paths under ``instantavatar_tpu.`` resolve to the same path
under ``instantavatar_torch.``; a target the port does not have raises
``ImportError`` naming it, and the JAX package is never imported.

Supported surface (everything the reference confs actually use):
  * ``defaults:`` lists — ``- group: option`` loads ``<conf_dir>/group/option.yaml``
    under key ``group``; ``- name`` merges ``<conf_dir>/name.yaml`` at the root.
  * ``${a.b.c}`` interpolation anywhere in the tree (resolved after merging).
  * CLI overrides: ``group=option`` (swap a defaults-group choice),
    ``a.b.c=value`` (set a leaf, YAML-parsed), ``+a.b=value`` (add new key).
  * ``instantiate(node, **kw)`` with ``_target_`` dotted class paths and
    ``_recursive_=False`` semantics (matching train.py:27-28 usage).
"""
from __future__ import annotations

import copy
import importlib
import re
from pathlib import Path
from typing import Any, Iterable

from . import yaml_lite

__all__ = ["Config", "load_config", "instantiate", "to_yaml", "merge"]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """A dict with attribute access, the unit of configuration.

    Deliberately *not* OmegaConf: plain data after resolution, safe to
    pass across process/jit boundaries (values are python scalars,
    lists, and nested Config).
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any, *, create: bool = True) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, dict):
                if part not in node or not isinstance(node[part], (dict, list)):
                    if not create:
                        raise KeyError(dotted)
                    node[part] = Config()
                node = node[part]
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                raise KeyError(dotted)
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = value
        else:
            node[last] = value

    def to_dict(self) -> dict:
        return _to_plain(self)

    def copy(self) -> "Config":  # type: ignore[override]
        return copy.deepcopy(self)


def _wrap(obj: Any) -> Any:
    """Recursively convert dicts to Config (and fix YAML-1.1 float quirk)."""
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    if isinstance(obj, str) and _SCI_FLOAT_RE.match(obj.strip()):
        return float(obj)  # YAML 1.1 reads bare "5e-4" as a string
    return obj


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_plain(v) for v in obj]
    return obj


def merge(base: Any, over: Any) -> Any:
    """Deep merge ``over`` onto ``base`` (over wins; dicts merge, others replace)."""
    if isinstance(base, dict) and isinstance(over, dict):
        out = Config(dict(base))
        for k, v in over.items():
            out[k] = merge(base[k], v) if k in base else _wrap(v)
        return out
    return _wrap(copy.deepcopy(over))


def _load_yaml(path: Path) -> Config:
    data = yaml_lite.safe_load(Path(path).read_text())
    return _wrap(data or {})


_SCI_FLOAT_RE = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+$")


def _parse_value(text: str) -> Any:
    """YAML-parse a single override value (so 1e-3, true, [1,2] work).

    YAML 1.1 reads ``5e-4`` as a string (needs ``5.0e-4``); coerce
    scientific-notation floats the way OmegaConf's grammar does.
    """
    if _SCI_FLOAT_RE.match(text.strip()):
        return float(text)
    try:
        return _wrap(yaml_lite.safe_load(text))
    except yaml_lite.YAMLError:
        return text


# ---------------------------------------------------------------------------
# composition


def _compose_file(conf_dir: Path, rel_name: str,
                  group_choices: dict[str, str]) -> Config:
    """Load one config file, recursively processing its ``defaults`` list.

    ``group_choices`` maps a defaults-group (e.g. ``dataset``) to a CLI-chosen
    option overriding the one named in the file (Hydra's ``group=option``).
    """
    path = conf_dir / (rel_name + ".yaml")
    if not path.exists():
        raise FileNotFoundError(f"config file not found: {path}")
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", None)
    merged: Config = Config()
    self_done = False
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                merged = merge(merged, raw)
                self_done = True
                continue
            if isinstance(entry, str):
                merged = merge(merged, _compose_file(conf_dir, entry, group_choices))
                continue
            if isinstance(entry, dict):
                (group, option), = entry.items()
                optional = False
                if isinstance(group, str) and group.startswith("optional "):
                    optional, group = True, group[len("optional "):]
                option = group_choices.get(group, option)
                if option is None:
                    continue
                sub_rel = f"{group}/{option}"
                try:
                    sub = _compose_file(conf_dir, sub_rel, group_choices)
                except FileNotFoundError:
                    if optional:
                        continue
                    raise
                # group configs land under the group key (leaf of the path)
                key = group.split("/")[-1]
                merged = merge(merged, Config({key: sub}))
    if not self_done:
        merged = merge(merged, raw)
    return merged


def _resolve_interpolations(cfg: Config) -> Config:
    """Resolve every ``${a.b}`` reference against the root config."""

    def resolve(node: Any, stack: tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return Config({k: resolve(v, stack) for k, v in node.items()})
        if isinstance(node, list):
            return [resolve(v, stack) for v in node]
        if isinstance(node, str):
            return resolve_str(node, stack)
        return node

    def resolve_str(text: str, stack: tuple[str, ...]) -> Any:
        full = _INTERP_RE.fullmatch(text)
        if full:
            return lookup(full.group(1), stack)

        def sub(m: re.Match) -> str:
            return str(lookup(m.group(1), stack))

        return _INTERP_RE.sub(sub, text)

    def lookup(key: str, stack: tuple[str, ...]) -> Any:
        if key in stack:
            raise ValueError(f"interpolation cycle: {' -> '.join(stack + (key,))}")
        val = cfg.get_path(key, default=_MISSING)
        if val is _MISSING:
            raise KeyError(f"interpolation key not found: ${{{key}}}")
        if isinstance(val, str) and _INTERP_RE.search(val):
            return resolve_str(val, stack + (key,))
        if isinstance(val, (dict, list)):
            return resolve(val, stack + (key,))
        return val

    return resolve(cfg, ())


_MISSING = object()


def load_config(conf_dir: str | Path, name: str,
                overrides: Iterable[str] = ()) -> Config:
    """Compose ``<conf_dir>/<name>.yaml`` with Hydra-style CLI overrides."""
    conf_dir = Path(conf_dir)
    group_choices: dict[str, str] = {}
    kv_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        additive = ov.startswith("+")
        if additive:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, val = ov.split("=", 1)
        # a bare group name (no dot) that matches a conf subdir is a group swap
        if not additive and "." not in key and (conf_dir / key).is_dir():
            group_choices[key] = val
        else:
            kv_overrides.append((key, _parse_value(val)))

    cfg = _compose_file(conf_dir, name, group_choices)
    # a missing key is set even without "+" (Hydra would raise), as the
    # JAX package's engine does
    for key, val in kv_overrides:
        existing = cfg.get_path(key, default=_MISSING)
        if isinstance(existing, dict) and isinstance(val, dict):
            cfg.set_path(key, merge(existing, val))
        else:
            cfg.set_path(key, val)
    return _resolve_interpolations(cfg)


def to_yaml(cfg: Config) -> str:
    return yaml_lite.safe_dump(_to_plain(cfg))


_JAX_PACKAGE = "instantavatar_tpu."


def _locate(target: str) -> Any:
    """Import a dotted path (module.Class or module.fn). Targets in the JAX
    package name the port's module of the same path."""
    path = target
    if target.startswith(_JAX_PACKAGE):
        path = "instantavatar_torch." + target[len(_JAX_PACKAGE):]
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        obj: Any = mod
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    if path != target:
        raise ImportError(f"cannot locate target {target}: the PyTorch port "
                          f"has no {path}")
    raise ImportError(f"cannot locate target: {target}")


def instantiate(node: Any, *args: Any, _recursive_: bool | None = None,
                **kwargs: Any) -> Any:
    """Instantiate a ``_target_`` node (mirrors hydra.utils.instantiate).

    Matches the reference's use (`train.py:27-28`): non-recursive by default
    unless the node sets ``_recursive_: true`` — nested ``_target_`` nodes are
    passed through as Config for the object to instantiate itself.
    """
    if not isinstance(node, dict) or "_target_" not in node:
        return node
    node = Config(dict(node))
    target = node.pop("_target_")
    recursive = node.pop("_recursive_", False) if _recursive_ is None else _recursive_
    node.pop("_convert_", None)
    cls = _locate(target)
    kw = dict(node)
    if recursive:
        kw = {k: instantiate(v, _recursive_=True) if isinstance(v, dict) else v
              for k, v in kw.items()}
    kw.update(kwargs)
    return cls(*args, **kw)
