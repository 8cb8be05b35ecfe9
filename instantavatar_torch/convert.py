"""State carried between the JAX package and the port through numpy.

Works on numpy arrays only (never imports jax): tests pass
``jax.tree.map(np.asarray, params)`` in, so both packages compute from the
same weights. ``seeded_field_params`` and ``seeded_ngp_params`` make such
weights from a numpy seed, for runs where JAX is not installed (the smoke
run on the GPU). ``train_state_from_numpy`` carries a whole JAX ``TrainState``
across: field params (any of the three feature fields), Adam moments and count, grid, step,
the canonical bake (SNARF's; the SMPL deformer's empty one becomes the
bbox the normalization implies) and the per-frame SMPL parameters;
``checkpoint_from_jax_state`` writes one into a run directory as the
port's checkpoint, so the port's CLIs render an avatar that JAX trained.
``grid_state_from_numpy`` takes one grid or ``smpl_init``'s stacked
per-frame grids. ``lpips_from_numpy`` builds the port's LPIPS from JAX's
``LPIPSParams`` (its random trunk included), so both packages compute the
same distance.
"""
from __future__ import annotations

import numpy as np
import torch

from .deformers.fast_snarf import SnarfCanonical
from .deformers.smpl_deformer import SMPLCanonical
from .ops.grid_sample import pack_corners_3d
from .render.density_grid import DensityGridState

__all__ = ["field_params_from_numpy", "triplane_params_from_numpy",
           "vanilla_nerf_params_from_numpy", "seeded_field_params",
           "seeded_ngp_params", "snarf_canonical_from_numpy",
           "grid_state_from_numpy", "train_state_from_numpy",
           "checkpoint_from_jax_state", "lpips_from_numpy"]

_FEATURES = ("voxel", "plane_xy", "plane_xz", "plane_yz", "table")
_MLPS = ("sigma_w", "sigma_b", "color_w", "color_b")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _has(obj, name) -> bool:
    return name in obj if isinstance(obj, dict) else hasattr(obj, name)


def field_params_from_numpy(params) -> dict[str, torch.Tensor]:
    """``VoxelTriplaneParams``, ``NGPParams`` or ``TriPlaneParams`` fields
    (numpy; NamedTuple
    or dict) -> the matching field's state dict of CPU float32 tensors
    (load it with ``field.load_state_dict``, which copies onto the
    field's device)."""
    sd = {k: torch.as_tensor(np.array(_get(params, k), np.float32))
          for k in _FEATURES if _has(params, k)}
    for k in _MLPS:
        for i, a in enumerate(_get(params, k)):
            sd[f"{k}.{i}"] = torch.as_tensor(np.array(a, np.float32))
    return sd


def triplane_params_from_numpy(params) -> dict[str, torch.Tensor]:
    """``TriPlaneParams`` fields (numpy; NamedTuple or dict) ->
    ``TriPlaneField``'s state dict: the (C, H, W) planes and the MLPs keep
    their names, as in ``field_params_from_numpy``."""
    if _has(params, "voxel") or not all(
            _has(params, k) for k in ("plane_xy", "plane_xz", "plane_yz")):
        raise ValueError("not TriPlaneParams: need plane_xy/xz/yz and no "
                         "voxel")
    return field_params_from_numpy(params)


def vanilla_nerf_params_from_numpy(params) -> dict[str, torch.Tensor]:
    """``VanillaNeRFParams`` (numpy; ``w`` and ``b`` tuples) ->
    ``VanillaNeRF``'s state dict (``w.i``, ``b.i``)."""
    return {f"{k}.{i}": torch.as_tensor(np.array(a, np.float32))
            for k in ("w", "b") for i, a in enumerate(_get(params, k))}


def seeded_field_params(voxel_res: int, plane_res: int, seed: int, *,
                        voxel_feats: int = 8, plane_feats: int = 16,
                        feat_std: float = 0.5,
                        sigma_bias: float | None = None
                        ) -> dict[str, object]:
    """Field params from a numpy seed, as a dict with the
    ``VoxelTriplaneParams`` field names (MLP entries are lists): features
    N(0, feat_std^2), He-init head weights, zero biases, and
    ``sigma_bias`` written into the raw-sigma output bias (an opaque field,
    like a trained avatar)."""
    rng = np.random.default_rng(seed)
    enc_dim = voxel_feats + 3 * plane_feats

    def feat(*shape):
        return (feat_std * rng.standard_normal(shape)).astype(np.float32)

    def mlp(dims):
        ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
              .astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
        return ws, [np.zeros((b,), np.float32) for b in dims[1:]]

    Gv, Gp = voxel_res + 1, plane_res + 1
    out = {"voxel": feat(Gv, Gv, Gv, voxel_feats),
           "plane_xy": feat(Gp, Gp, plane_feats),
           "plane_xz": feat(Gp, Gp, plane_feats),
           "plane_yz": feat(Gp, Gp, plane_feats)}
    out["sigma_w"], out["sigma_b"] = mlp((enc_dim, 64, 16))
    out["color_w"], out["color_b"] = mlp((15, 64, 64, 3))
    if sigma_bias is not None:
        out["sigma_b"][-1][0] = sigma_bias
    return out


def seeded_ngp_params(n_levels: int, table_size: int, seed: int, *,
                      n_features: int = 2, table_std: float = 0.1,
                      sigma_bias: float | None = None) -> dict[str, object]:
    """NGP field params from a numpy seed, as a dict with the ``NGPParams``
    field names (MLP entries are lists): table N(0, table_std^2) of shape
    (n_levels, table_size, n_features), He-init head weights, zero
    biases, and ``sigma_bias`` written into the raw-sigma output bias."""
    rng = np.random.default_rng(seed)
    out = {"table": (table_std * rng.standard_normal(
        (n_levels, table_size, n_features), np.float32))}

    def mlp(dims):
        ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
              .astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
        return ws, [np.zeros((b,), np.float32) for b in dims[1:]]

    out["sigma_w"], out["sigma_b"] = mlp((n_levels * n_features, 64, 16))
    out["color_w"], out["color_b"] = mlp((15, 64, 64, 3))
    if sigma_bias is not None:
        out["sigma_b"][-1][0] = sigma_bias
    return out


def snarf_canonical_from_numpy(cano, *, device: torch.device | str
                               ) -> SnarfCanonical:
    """JAX ``SnarfCanonical`` fields (numpy) -> the port's canonical state
    on ``device``. The bf16 ``lbs_packed`` rows (a numpy bfloat16 array)
    come across exactly as torch bf16; where the packed rows are absent
    they are packed from ``lbs_voxel`` (packing is exact)."""
    packed = ("lbs_packed", "lbs_packed32")
    out = {k: torch.as_tensor(np.array(_get(cano, k)), device=device)
           for k in SnarfCanonical._fields if k not in packed}
    if all((k in cano) if isinstance(cano, dict) else hasattr(cano, k)
           for k in packed):
        out["lbs_packed32"] = torch.as_tensor(
            np.array(_get(cano, "lbs_packed32")), device=device)
        out["lbs_packed"] = torch.as_tensor(
            np.asarray(_get(cano, "lbs_packed")).astype(np.float32),
            device=device).to(torch.bfloat16)
    else:
        out["lbs_packed32"] = pack_corners_3d(out["lbs_voxel"])
        out["lbs_packed"] = out["lbs_packed32"].to(torch.bfloat16)
    return SnarfCanonical(**out)


def grid_state_from_numpy(grid, *, device: torch.device | str
                          ) -> DensityGridState:
    """JAX ``DensityGridState`` fields (numpy) -> the port's grid state,
    of any leading shape (``smpl_init``'s (F, G, G, G) stack, its aabb
    (F, 2, 3))."""
    return DensityGridState(
        density_cached=torch.as_tensor(
            np.array(_get(grid, "density_cached"), np.float32),
            device=device),
        occupancy=torch.as_tensor(np.array(_get(grid, "occupancy"), bool),
                                  device=device),
        aabb=torch.as_tensor(np.array(_get(grid, "aabb"), np.float32),
                             device=device))


def _adam_state(opt_state, group: str = "field"):
    """The optax ``ScaleByAdamState`` (count, mu, nu) of one parameter
    group inside a numpy copy of ``make_optimizer``'s state
    (apply_if_finite -> multi_transform -> {group: masked -> (adam,
    schedule)}): the first node with mu and nu fields under the dict entry
    ``group``; None where the group has no Adam."""
    def find(node, inside):
        if inside and hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, dict):
            kids = ([(node[group], True)] if group in node
                    else [(v, inside) for v in node.values()])
        elif isinstance(node, (tuple, list)):
            kids = [(v, inside) for v in node]
        else:
            kids = []
        for kid, ins in kids:
            found = find(kid, ins)
            if found is not None:
                return found
        return None
    return find(opt_state, False)


def train_state_from_numpy(state, field, model, *,
                           device: torch.device | str):
    """A numpy copy of a JAX ``TrainState`` (``jax.tree.map(np.asarray,
    state)``; params ``{"field": VoxelTriplaneParams | NGPParams, "smpl":
    SMPLParams | ()}``, opt state from ``make_optimizer``) -> the port's
    ``TrainState``: the field params are loaded into ``field`` (the module
    ``model`` trains), the SMPL parameters become the state's leaves when
    ``model.optimize_smpl``, the optimizer is bound to both with each
    group's Adam moments and count, and grid, canonical bake,
    normalization and step come across."""
    from .train.model import TrainState
    from .train.smpl_params import SMPLParams
    field.load_state_dict(field_params_from_numpy(state.params["field"]))
    jsmpl = state.params.get("smpl")
    smpl = (SMPLParams.from_arrays(jsmpl._asdict(), device=device)
            if model.optimize_smpl and hasattr(jsmpl, "_asdict") else None)
    opt = model.optimizer.init({"field": list(field.parameters()),
                                "smpl": list(smpl or ())})
    adam = _adam_state(state.opt_state)
    if adam is not None and opt.field is not None:
        names = [n for n, _ in field.named_parameters()]
        mu = field_params_from_numpy(adam.mu["field"])
        nu = field_params_from_numpy(adam.nu["field"])
        opt.load_moments([mu[n] for n in names], [nu[n] for n in names],
                         int(adam.count))
    adam = _adam_state(state.opt_state, "smpl")
    if adam is not None and opt.smpl is not None:
        opt.load_moments([torch.as_tensor(np.array(a).reshape(p.shape))
                          for a, p in zip(adam.mu["smpl"], smpl)],
                         [torch.as_tensor(np.array(a).reshape(p.shape))
                          for a, p in zip(adam.nu["smpl"], smpl)],
                         int(adam.count), group="smpl")
    center = torch.as_tensor(np.array(state.center), device=device)
    scale = torch.as_tensor(np.array(state.scale), device=device)
    cano = (SMPLCanonical(bbox=torch.stack([center - scale / 2,
                                            center + scale / 2]))
            if len(state.deformer_cano) == 0   # JAX's SMPLDeformer: ()
            else snarf_canonical_from_numpy(state.deformer_cano,
                                            device=device))
    return TrainState(
        deformer_cano=cano,
        grid=grid_state_from_numpy(state.grid, device=device),
        center=center, scale=scale,
        opt_state=opt, step=int(state.step), smpl=smpl)


def checkpoint_from_jax_state(state, field, model, path):
    """A numpy copy of a JAX ``TrainState`` -> a checkpoint of the port
    under the run directory ``path`` (``path/checkpoints/step_%08d``), on
    ``field``'s device, through ``train_state_from_numpy`` and
    ``save_checkpoint``. Returns the checkpoint directory."""
    from pathlib import Path

    from .train.harness import save_checkpoint
    tstate = train_state_from_numpy(state, field, model,
                                    device=next(field.parameters()).device)
    return save_checkpoint(Path(path) / "checkpoints", tstate, field)


def lpips_from_numpy(params, net: str, *, numerically_matched: bool = False,
                     device: torch.device | str = "cpu"):
    """A numpy copy of JAX's ``LPIPSParams`` (``convs``: ((w HWIO, b),
    ...), ``heads``: five (C,)) -> the port's ``LPIPS`` on ``device``, the
    convolutions in OIHW."""
    from .losses.lpips import LPIPS
    convs = [(np.asarray(w, np.float32).transpose(3, 2, 0, 1),
              np.asarray(b, np.float32)) for w, b in _get(params, "convs")]
    heads = [np.asarray(h, np.float32) for h in _get(params, "heads")]
    return LPIPS(net, convs, heads,
                 numerically_matched=numerically_matched).to(device)
