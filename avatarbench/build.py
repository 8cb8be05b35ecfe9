"""Models and weights from a configuration file, for the program and for
the plain reference alike.

A configuration names each part by its class and gives its arguments:
``{"class": "SNARFDeformer", "resolution": 128, ...}``; an argument that
is itself such an object is built first. ``make_model(lib, cfg, device)``
builds an ``AvatarModel`` from ``lib``, the program's modules
(``program_lib``) or the reference's frozen copy (``reference_lib``),
which have the same names: the body (``cfg["body"]``), the field
(``cfg["field"]``, checked against the widths ``cfg["widths"]`` states),
the deformer (``cfg["deformer"]``, given the body first) and the model's
knobs (``cfg["avatar"]``, with ``cfg["optimizer"]`` when the
configuration trains). ``make_weights(cfg, shapes, seed, device)`` makes
the field's weights on the device from the seed, in a few large calls of
a ``torch.Generator`` on the card: every feature table in one draw, every
MLP weight in another. ``load_weights`` copies them into a field by
parameter name.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

__all__ = ["program_lib", "reference_lib", "construct", "make_body",
           "make_model", "make_weights", "load_weights", "field_shapes"]

MODULES = ("body", "data", "deformers", "models", "ops", "train")


def program_lib() -> SimpleNamespace:
    """The program's modules, imported only when a run needs them."""
    import importlib
    return SimpleNamespace(**{m: importlib.import_module(
        f"instantavatar_torch.{m}") for m in MODULES})


def reference_lib() -> SimpleNamespace:
    """The reference's frozen copy of the same modules."""
    import importlib
    return SimpleNamespace(**{m: importlib.import_module(
        f"avatarbench.reference.plain.{m}") for m in MODULES})


def find(lib, name: str):
    """The class or function ``name`` in one of ``lib``'s modules."""
    for m in MODULES:
        got = getattr(getattr(lib, m), name, None)
        if got is not None:
            return got
    raise ValueError(f"no {name!r} in {', '.join(MODULES)}")


def construct(lib, spec: dict, *args, **extra):
    """``spec["class"]`` called with ``args``, ``spec``'s other keys (an
    object with a ``"class"`` built first) and ``extra``."""
    kw = {k: (construct(lib, v) if isinstance(v, dict) and "class" in v
              else v) for k, v in spec.items() if k != "class"}
    return find(lib, spec["class"])(*args, **kw, **extra)


def make_body(lib, cfg: dict, device):
    return construct(lib, cfg["body"], device=device)


def make_field(lib, cfg: dict, device):
    field = construct(lib, cfg["field"], device=device)
    for k, want in cfg.get("widths", {}).items():
        if tuple(getattr(field, k)) != tuple(want):
            raise ValueError(f"the field's {k} {getattr(field, k)} is not "
                             f"the configuration's {want}")
    return field


def make_model(lib, cfg: dict, device, steps_per_epoch: int = 100):
    """The configuration's ``AvatarModel`` from ``lib`` on ``device``."""
    body = make_body(lib, cfg, device)
    deformer = construct(lib, cfg["deformer"], body)
    kw = dict(cfg["avatar"])
    if "optimizer" in cfg:
        kw["optimizer"] = construct(lib, cfg["optimizer"],
                                    steps_per_epoch=steps_per_epoch)
    return lib.train.AvatarModel(body, make_field(lib, cfg, device),
                                 deformer, **kw)


def field_shapes(field) -> dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in field.named_parameters()}


def _is_mlp(name: str) -> bool:
    return name.split(".")[0] in ("sigma_w", "sigma_b", "color_w", "color_b")


@torch.no_grad()
def make_weights(cfg: dict, shapes: dict[str, tuple], seed: int,
                 device) -> dict[str, torch.Tensor]:
    """The field's weights from ``seed``, on ``device``, as
    ``cfg["weights"]`` says: the feature tables U(-a, a) (``"uniform":
    a``, a fresh field) or N(0, s^2) (``"normal": s``, a seeded one) in
    one draw, the MLP weights He-initialised in one draw, zero biases; a
    ``"sigma_bias"`` goes into the raw-sigma output bias."""
    w = cfg["weights"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    feats = [n for n in shapes if not _is_mlp(n)]
    mlp_w = [n for n in shapes if n.split(".")[0] in ("sigma_w", "color_w")]
    out: dict[str, torch.Tensor] = {}
    sizes = [math.prod(shapes[n]) for n in feats]
    if "normal" in w:
        flat = torch.randn(sum(sizes), generator=gen, device=device) \
            * w["normal"]
    else:
        flat = torch.rand(sum(sizes), generator=gen, device=device) \
            * (2 * w["uniform"]) - w["uniform"]
    for n, part in zip(feats, flat.split(sizes)):
        out[n] = part.reshape(shapes[n])
    sizes = [math.prod(shapes[n]) for n in mlp_w]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for n, part in zip(mlp_w, flat.split(sizes)):
        out[n] = part.reshape(shapes[n]) * math.sqrt(2.0 / shapes[n][0])
    for n in shapes:
        if n.split(".")[0] in ("sigma_b", "color_b"):
            out[n] = torch.zeros(shapes[n], device=device)
    if w.get("sigma_bias") is not None:
        last = max((n for n in shapes if n.startswith("sigma_b.")),
                   key=lambda n: int(n.split(".")[1]))
        out[last][0] = w["sigma_bias"]
    return out


@torch.no_grad()
def load_weights(field, weights: dict[str, torch.Tensor]) -> None:
    names = dict(field.named_parameters())
    if set(names) != set(weights):
        raise ValueError(f"the field's parameters {sorted(names)} are not "
                         f"the weights' {sorted(weights)}")
    for n, p in names.items():
        p.copy_(weights[n])
