"""The SMPL-deformer frame for the PyTorch port's tests.

``main`` renders the JAX flat-stream frame of the in-the-wild demo's
fitting deformer (toy body, the nearest-vertex ``SMPLDeformer``,
``NGPField()`` at the default 16 x 2 @ 2^19 hash grid, the posed-body
shell grid) on the CPU at 48 x 48 and writes it, with every input the
port needs to render the same frame, to ``tests/data/torch_smpl_golden.npz``.
The field's weights are not stored: ``seed``, ``table_std`` and
``sigma_bias`` remake them (``instantavatar_torch.convert.
seeded_ngp_params``, numpy only). The port renders it with
``render_golden`` (numpy and torch only) in
``tests/test_torch_smpl_deformer.py`` (CPU) and ``chip_smoke.py`` (GPU).

``jax_smpl_avatar`` and ``port_smpl_avatar`` make the same avatar in
either package, on any hash grid, for the parity tests.

Run:  JAX_PLATFORMS=cpu python tools/make_torch_smpl_golden.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import make_torch_ngp_golden as ngp_golden  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "torch_smpl_golden.npz"
CONFIG = dict(image_hw=48, grid_size=32, seed=0, table_std=0.5,
              sigma_bias=100.0, shell_margin=0.08, threshold=0.12,
              bone_rings=3)
AVATAR_KW = dict(n_steps=128, k_cap=8, eval_n_steps=48, cache_n_cand=1,
                 eval_grid="smpl_shell")


def jax_smpl_avatar(grid=None, c=CONFIG, **overrides):
    """JAX ``AvatarModel``: toy body, ``SMPLDeformer(threshold)``,
    ``NGPField(grid)`` (default grid when None)."""
    from instantavatar_tpu.body import toy_smpl_model
    from instantavatar_tpu.deformers import SMPLDeformer
    from instantavatar_tpu.models import NGPField
    from instantavatar_tpu.ops.hashgrid import HashGridConfig
    from instantavatar_tpu.train import AvatarModel
    body = toy_smpl_model(bone_rings=c["bone_rings"])
    field = NGPField() if grid is None else NGPField(
        grid=HashGridConfig(**grid))
    return AvatarModel(body, field,
                       SMPLDeformer(body, threshold=c["threshold"]),
                       **{**AVATAR_KW, "grid_size": c["grid_size"],
                          "shell_margin": c["shell_margin"], **overrides})


def port_smpl_avatar(grid=None, c=CONFIG, device="cpu", **overrides):
    """The port's ``AvatarModel`` in the same configuration."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.models import NGPField
    from instantavatar_torch.ops import HashGridConfig
    from instantavatar_torch.train import AvatarModel
    body = toy_smpl_model(bone_rings=c["bone_rings"], device=device)
    field = NGPField(device=device) if grid is None else NGPField(
        grid=HashGridConfig(**grid), device=device)
    return AvatarModel(body, field,
                       SMPLDeformer(body, threshold=c["threshold"]),
                       **{**AVATAR_KW, "grid_size": c["grid_size"],
                          "shell_margin": c["shell_margin"], **overrides})


def seed_port_field(field, c=CONFIG) -> None:
    """Load ``seeded_ngp_params`` (the golden's seed) into the port's
    field."""
    from instantavatar_torch import convert
    g = field.grid
    field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_ngp_params(g.n_levels, g.table_size, int(c["seed"]),
                                  n_features=g.n_features,
                                  table_std=float(c["table_std"]),
                                  sigma_bias=float(c["sigma_bias"]))))


def render_golden(device="cpu", path=GOLDEN) -> dict:
    """The port's render of the golden frame on ``device`` (numpy and
    torch only): its rgb and alpha, the golden's, and the PSNR."""
    import torch
    from instantavatar_torch import convert
    g = np.load(path)
    H, G = int(g["image_hw"]), int(g["grid_size"])
    c = {k: g[k].item() for k in CONFIG}
    avatar = port_smpl_avatar(c=c, device=device)
    seed_port_field(avatar.field, c)
    state = avatar.init(g["betas"])
    occ = np.unpackbits(g["occupancy_bits"])[:G ** 3].astype(bool)
    grid = convert.grid_state_from_numpy(
        {"density_cached": np.zeros((G, G, G), np.float32),
         "occupancy": occ.reshape(G, G, G), "aabb": g["aabb"]}, device=device)
    batch = {k: g[k] for k in ("ray_basis", "betas", "body_pose",
                               "global_orient", "transl")}
    with torch.no_grad():
        out = avatar.render_frame(state, batch, grid=grid, image_shape=(H, H))
    rgb = out["rgb"].double().cpu().numpy()
    mse = float(np.mean((rgb - g["rgb"]) ** 2))
    return {"rgb": rgb, "alpha": out["alpha"].cpu().numpy(),
            "golden_rgb": g["rgb"], "golden_alpha": g["alpha"],
            "psnr": 10 * np.log10(1.0 / max(mse, 1e-20)), "image_hw": H}


def main() -> None:
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
    c = CONFIG
    H = c["image_hw"]
    avatar = jax_smpl_avatar()
    state = avatar.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    params = ngp_golden.jax_ngp_params(avatar.field.grid, c["seed"],
                                       c["table_std"], c["sigma_bias"])
    state = state._replace(params={**state.params, "field": params})
    batch = {**ngp_golden.golden_inputs(H), "near": np.float32(4.0),
             "far": np.float32(6.0)}
    grid = avatar.build_pose_grid(state, batch)
    out = avatar.render_frame(state, batch, grid=grid, image_shape=(H, H))
    occ = np.asarray(grid.occupancy)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GOLDEN, rgb=np.asarray(out["rgb"], np.float32),
             alpha=np.asarray(out["alpha"], np.float32),
             occupancy_bits=np.packbits(occ.reshape(-1)),
             aabb=np.asarray(grid.aabb, np.float32),
             **ngp_golden.golden_inputs(H),
             **{k: np.asarray(v) for k, v in c.items()})
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes): alpha mean "
          f"{float(np.mean(out['alpha'])):.4f}, occupied cells {occ.sum()}")


if __name__ == "__main__":
    main()
