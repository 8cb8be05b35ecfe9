"""Config -> objects builder.

Port of ``instantavatar_tpu/config/build.py``: the same conf-tree surface
(groups, keys, interpolations) assembled into the port's objects on one
``device``: body model, field, deformer, renderer knobs, loss weights,
grouped Adam, datamodule and trainer. ``network=mlp`` raises
``NotImplementedError`` from ``check_ported`` before anything is built or
trained: ``VanillaNeRF`` is ported as a module, but no ``AvatarModel`` can
evaluate it, in either package (see ``MLP_REFUSAL``).
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any

import torch

__all__ = ["check_ported", "build_body_model", "build_field",
           "build_deformer", "build_avatar", "build_datamodule",
           "build_trainer"]

MLP_REFUSAL = (
    "network=mlp (VanillaNeRF) cannot drive an AvatarModel: its apply "
    "takes (x, d=None) (instantavatar_tpu/models/mlp.py:65) while "
    "AvatarModel calls field.apply(params, x, center, scale) "
    "(instantavatar_tpu/train/model.py:429), so the JAX package cannot "
    "render or train it either; the port has the module "
    "(instantavatar_torch.models.VanillaNeRF) but not that pairing. Use "
    "network=ngp, network=voxel_triplane or network=triplane")


def _field_kind(network_cfg: Any) -> str:
    """The field class a network conf names. JAX's ``build_field`` reads
    the same tests but misses ``VanillaNeRF`` (``confs/network/mlp.yaml``)
    and, its ``"triplane" in target`` being case-sensitive,
    ``TriPlaneField`` (``confs/network/triplane.yaml``): it builds both as
    an NGPField. Here they are the mlp and triplane fields (a departure
    from JAX's builder, ROADMAP fault 3.2)."""
    target = str(network_cfg.get("_target_", ""))
    name = target.rsplit(".", 1)[-1].lower()
    if "voxeltriplane" in name or "voxel_triplane" in target:
        return "voxel_triplane"
    if "triplane" in name:
        return "triplane"
    if "mlp" in target or "nerfnet" in name or name == "vanillanerf":
        return "mlp"
    return "ngp"


def _is_smpl_deformer(deformer_cfg: Any) -> bool:
    target = str(deformer_cfg.get("_target_", ""))
    return ("smpl_deformer" in target.lower()
            or target.rsplit(".", 1)[-1] == "SMPLDeformer")


def check_ported(cfg: Any) -> None:
    """Raise ``NotImplementedError`` for an option of a composed config
    that no ``AvatarModel`` runs: the mlp network."""
    if _field_kind(cfg.get("network", {}) or {}) == "mlp":
        raise NotImplementedError(MLP_REFUSAL)


def build_body_model(deformer_cfg: Any, device: torch.device | str):
    """SMPL body model from the deformer conf (model_path + gender). Falls
    back to the deterministic toy body, with a warning, when the
    license-gated SMPL file is absent."""
    from ..body import toy_smpl_model
    from ..body.loader import load_smpl_model
    path = deformer_cfg.get("model_path", "")
    gender = deformer_cfg.get("gender", "neutral")
    try:
        return load_smpl_model(path, gender, device=device)
    except (FileNotFoundError, OSError, KeyError):
        warnings.warn(
            f"SMPL model not found under {path!r} (gender={gender}); "
            "falling back to the synthetic toy body. Download SMPL pkls "
            "for real data.", stacklevel=2)
        return toy_smpl_model(device=device)


def build_field(network_cfg: Any, device: torch.device | str):
    """The field a network conf names. ``ngp`` is ``NGPField()`` at its
    default grid: like JAX, the conf's use_viewdir, cond_dim, center and
    scale are not read (the canonical bbox sets center and scale);
    ``triplane`` is ``TriPlaneField()`` (32 x 256 x 256 planes; its conf
    has no options); ``mlp`` raises (``MLP_REFUSAL``)."""
    from ..models import NGPField, TriPlaneField, VoxelTriplaneField
    kind = _field_kind(network_cfg)
    if kind == "ngp":
        return NGPField(device=device)
    if kind == "triplane":
        return TriPlaneField(device=device)
    if kind == "mlp":
        raise NotImplementedError(MLP_REFUSAL)
    opt = network_cfg.get("opt", {}) or {}
    kw = {k: int(opt[k]) for k in ("voxel_res", "voxel_feats", "plane_res",
                                   "plane_feats") if k in opt}
    return VoxelTriplaneField(**kw, device=device)


def build_deformer(deformer_cfg: Any, body_model):
    from ..deformers import SMPLDeformer, SNARFDeformer
    if _is_smpl_deformer(deformer_cfg):
        return SMPLDeformer(body_model,
                            threshold=float(deformer_cfg.get("threshold",
                                                             0.05)))
    opt = deformer_cfg.get("opt", {}) or {}
    n_init = opt.get("n_init_active")
    return SNARFDeformer(
        body_model,
        resolution=int(opt.get("resolution", 128)),
        cano_pose=str(opt.get("cano_pose", "a_pose")).lower(),
        version=int(opt.get("version", 1)),
        n_init_active=None if n_init is None else int(n_init),
        cand_cap=int(opt.get("cand_cap", 4)))


def build_datamodule(cfg: Any):
    from ..data import AvatarDataModule
    node = cfg.dataset
    return AvatarDataModule(node.opt if "opt" in node else node)


def build_avatar(cfg: Any, steps_per_epoch: int = 100, *,
                 device: torch.device | str):
    """Assemble the AvatarModel from a composed config."""
    from ..train import AvatarModel, make_optimizer
    check_ported(cfg)
    mopt = cfg.model.opt
    body = build_body_model(cfg.deformer, device)
    field = build_field(cfg.network, device)
    deformer = build_deformer(cfg.deformer, body)

    ropt = cfg.get("renderer", {}) or {}
    n_steps = int(ropt.get("MAX_SAMPLES", ropt.get("n_steps", 256)))
    # the reference caps samples per iteration at MAX_BATCH_SIZE; the
    # static analog caps evaluated samples per ray
    k_cap = ropt.get("k_cap")
    loss_opt = (mopt.get("loss", {}) or {}).get("opt", {}) or {}
    lpips_fn = None
    if float(loss_opt.get("w_lpips", 0)) > 0:
        # the reference's NGPLoss carries a frozen VGG-LPIPS; without a
        # trunk file the trunk is random (a warning says so)
        from ..losses.lpips import load_lpips
        lpips_fn = load_lpips("vgg", allow_random=True, device=device)
    sched = mopt.get("scheduler", {}) or {}
    oopt = mopt.get("optimizer", {}) or {}
    opt_smpl = mopt.get("optimize_SMPL", {}) or {}
    optimize_smpl = bool(opt_smpl.get("enable", False))
    is_refine = bool(opt_smpl.get("is_refine", False))
    optimizer = make_optimizer(
        lr=float(oopt.get("lr", 1e-2)),
        smpl_lr=float(opt_smpl.get("lr", 1e-4)) if optimize_smpl else None,
        max_epochs=int(sched["max_epochs"]) if "max_epochs" in sched
        else None,
        steps_per_epoch=steps_per_epoch,
        freeze_field=is_refine,
        betas=tuple(float(b) for b in oopt.get("betas", (0.9, 0.99))),
        eps=float(oopt.get("eps", 1e-15)))
    return AvatarModel(
        body, field, deformer,
        n_steps=n_steps,
        k_cap=64 if k_cap is None else int(k_cap),
        grid_size=int(ropt.get("grid_size", 64)),
        optimize_smpl=optimize_smpl,
        is_refine=is_refine,
        smpl_init=bool(mopt.get("smpl_init", False)),
        train_warp_cache=bool(ropt.get("train_warp_cache", True)),
        # every configured loss weight goes through: AvatarModel raises on
        # a term it does not have rather than dropping it
        loss_weights={k: float(v) for k, v in loss_opt.items()},
        lpips_fn=lpips_fn,
        optimizer=optimizer)


def build_trainer(cfg: Any, workdir: str | Path = ".", *,
                  device: torch.device | str):
    """datamodule + avatar + Trainer from a composed config."""
    from ..train.harness import Trainer
    from ..train.optim import poly_decay_schedule
    check_ported(cfg)
    dm = build_datamodule(cfg)
    steps = len(dm.trainset) if hasattr(dm, "trainset") else 100
    avatar = build_avatar(cfg, steps_per_epoch=steps, device=device)
    tr = cfg.get("train", {}) or {}
    mopt = cfg.model.opt
    sched = mopt.get("scheduler", {}) or {}
    lr_schedule = None
    if "max_epochs" in sched:
        lr_schedule = poly_decay_schedule(
            float((mopt.get("optimizer", {}) or {}).get("lr", 1e-2)),
            int(sched["max_epochs"]), steps)
    return Trainer(
        avatar, dm, workdir=workdir,
        max_epochs=int(tr.get("max_epochs", 30)),
        check_val_every_n_epoch=int(tr.get("check_val_every_n_epoch", 10)),
        resume=bool(cfg.get("resume", True)),
        seed=int(cfg.get("seed", 42)),
        lr_schedule=lr_schedule)
