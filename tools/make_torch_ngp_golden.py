"""The NGP field for the PyTorch port's tests: the golden frame and the
shared model builders.

``main`` renders the JAX flat-stream frame (toy body, Fast-SNARF res 32,
``NGPField()`` at the default 16 x 2 @ 2^19 hash grid, the posed-body
shell grid) on the CPU at 48 x 48 and writes it, with every input the
port needs to render the same frame, to ``tests/data/torch_ngp_golden.npz``.
The field's weights are not stored: ``seed``, ``table_std`` and
``sigma_bias`` remake them (``instantavatar_torch.convert.
seeded_ngp_params``, numpy only). The port renders it in
``tests/test_torch_ngp.py`` (CPU) and ``chip_smoke.py`` (GPU).

The builders (``jax_ngp_avatar``, ``port_ngp_avatar``, ``jax_ngp_state0``)
make the reduced training configuration of
``tools/make_torch_train_golden.py`` with an NGP field on a small hash
grid (``SMALL_GRID``: 8 levels, 2^13 slots, levels 0-3 dense and 4-7
hashed), for the step-parity tests.

Run:  JAX_PLATFORMS=cpu python tools/make_torch_ngp_golden.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import make_torch_train_golden as train_golden  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "torch_ngp_golden.npz"
CONFIG = dict(image_hw=48, deformer_res=32, grid_size=32, seed=0,
              table_std=0.5, sigma_bias=100.0, shell_margin=0.08)
SMALL_GRID = dict(n_levels=8, log2_hashmap_size=13, base_resolution=4,
                  per_level_scale=1.6)
# the step tests' field: small table, an opaque mid-training-like field
STEP_PARAMS = dict(seed=0, table_std=0.1, sigma_bias=20.0)


def golden_inputs(H: int) -> dict[str, np.ndarray]:
    """Camera (bench framing scaled to H), mild arm pose, yawed body."""
    from instantavatar_torch.data.rays import make_ray_basis
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    pose[[46, 49]] = 0.2
    return {"ray_basis": make_ray_basis(K, np.eye(4)),
            "betas": np.zeros(10, np.float32), "body_pose": pose,
            "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
            "transl": np.array([0.0, 0.15, 5.0], np.float32)}


def jax_ngp_params(grid, seed: int, table_std: float, sigma_bias: float):
    """JAX ``NGPParams`` from ``seeded_ngp_params``."""
    import jax.numpy as jnp
    from instantavatar_torch.convert import seeded_ngp_params
    from instantavatar_tpu.models.ngp import NGPParams
    p = seeded_ngp_params(grid.n_levels, grid.table_size, seed,
                          n_features=grid.n_features, table_std=table_std,
                          sigma_bias=sigma_bias)
    return NGPParams(**{k: (tuple(map(jnp.asarray, v)) if isinstance(v, list)
                            else jnp.asarray(v)) for k, v in p.items()})


def jax_ngp_avatar(c=train_golden.CONFIG, version: int = 1, **overrides):
    """JAX ``AvatarModel`` in the training golden's configuration with an
    ``NGPField`` on ``SMALL_GRID`` (``overrides`` go to the model)."""
    from instantavatar_tpu.body import toy_smpl_model
    from instantavatar_tpu.deformers import SNARFDeformer
    from instantavatar_tpu.models import NGPField
    from instantavatar_tpu.ops.hashgrid import HashGridConfig
    from instantavatar_tpu.train import AvatarModel
    from instantavatar_tpu.train.optim import make_optimizer
    body = toy_smpl_model(bone_rings=c["bone_rings"])
    kw = dict(n_steps=c["n_steps"], k_cap=c["k_cap"],
              grid_size=c["grid_size"], noise_steps=c["noise_steps"],
              grid_update_interval=c["grid_update_interval"],
              optimizer=make_optimizer(c["lr"], max_epochs=c["max_epochs"],
                                       steps_per_epoch=c["steps_per_epoch"]))
    return AvatarModel(
        body, NGPField(grid=HashGridConfig(**SMALL_GRID)),
        SNARFDeformer(body, resolution=c["deformer_res"], cano_pose="a_pose",
                      n_iters=c["n_iters"], cand_cap=c["cand_cap"],
                      n_init_active=c["n_init_active"], version=version),
        **{**kw, **overrides})


def port_ngp_avatar(c=train_golden.CONFIG, device="cpu", version: int = 1,
                    **overrides):
    """The port's ``AvatarModel`` in the same configuration."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import NGPField
    from instantavatar_torch.ops import HashGridConfig
    from instantavatar_torch.train import AvatarModel, make_optimizer
    body = toy_smpl_model(bone_rings=c["bone_rings"], device=device)
    kw = dict(n_steps=c["n_steps"], k_cap=c["k_cap"],
              grid_size=c["grid_size"], noise_steps=c["noise_steps"],
              grid_update_interval=c["grid_update_interval"],
              optimizer=make_optimizer(c["lr"], max_epochs=c["max_epochs"],
                                       steps_per_epoch=c["steps_per_epoch"]))
    return AvatarModel(
        body, NGPField(grid=HashGridConfig(**SMALL_GRID), device=device),
        SNARFDeformer(body, resolution=c["deformer_res"], cano_pose="a_pose",
                      n_iters=c["n_iters"], cand_cap=c["cand_cap"],
                      n_init_active=c["n_init_active"], version=version),
        **{**kw, **overrides})


def jax_ngp_state0(avatar, betas, smpl_params=None):
    """JAX ``TrainState`` with the ``STEP_PARAMS`` field (and, with
    ``optimize_smpl``, ``smpl_params``) and a fresh optimizer state."""
    import jax
    import jax.numpy as jnp
    st = avatar.init(jax.random.PRNGKey(0), jnp.asarray(betas).reshape(1, -1),
                     smpl_params)
    params = {**st.params, "field": jax_ngp_params(avatar.field.grid,
                                                   **STEP_PARAMS)}
    return st._replace(params=params, opt_state=avatar.optimizer.init(params))


def render_golden(device="cpu", path=GOLDEN) -> dict:
    """The port's render of the golden frame on ``device`` (numpy and
    torch only): returns its rgb and alpha, the golden's, and the PSNR."""
    import torch
    from instantavatar_torch import convert
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import NGPField
    from instantavatar_torch.train import AvatarModel
    g = np.load(path)
    H, G = int(g["image_hw"]), int(g["grid_size"])
    body = toy_smpl_model(bone_rings=3, device=device)
    field = NGPField(device=device)
    grid_cfg = field.grid
    field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_ngp_params(grid_cfg.n_levels, grid_cfg.table_size,
                                  int(g["seed"]),
                                  n_features=grid_cfg.n_features,
                                  table_std=float(g["table_std"]),
                                  sigma_bias=float(g["sigma_bias"]))))
    avatar = AvatarModel(
        body, field,
        SNARFDeformer(body, resolution=int(g["deformer_res"]),
                      cano_pose="a_pose", n_iters=6, cand_cap=2,
                      n_init_active=4),
        n_steps=128, k_cap=8, grid_size=G, eval_n_steps=48, cache_n_cand=1,
        eval_grid="smpl_shell", shell_margin=float(g["shell_margin"]))
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
    from instantavatar_tpu.body import toy_smpl_model
    from instantavatar_tpu.deformers import SNARFDeformer
    from instantavatar_tpu.models import NGPField
    from instantavatar_tpu.train import AvatarModel

    c = CONFIG
    H = c["image_hw"]
    body = toy_smpl_model(bone_rings=3)
    field = NGPField()
    avatar = AvatarModel(
        body, field,
        SNARFDeformer(body, resolution=c["deformer_res"], cano_pose="a_pose",
                      n_iters=6, cand_cap=2, n_init_active=4),
        n_steps=128, k_cap=8, grid_size=c["grid_size"], eval_n_steps=48,
        cache_n_cand=1, eval_grid="smpl_shell",
        shell_margin=c["shell_margin"])
    state = avatar.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    params = jax_ngp_params(field.grid, c["seed"], c["table_std"],
                            c["sigma_bias"])
    state = state._replace(params={**state.params, "field": params})
    batch = {**golden_inputs(H), "near": np.float32(4.0),
             "far": np.float32(6.0)}
    grid = avatar.build_pose_grid(state, batch)
    out = avatar.render_frame(state, batch, grid=grid, image_shape=(H, H))
    occ = np.asarray(grid.occupancy)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GOLDEN, rgb=np.asarray(out["rgb"], np.float32),
             alpha=np.asarray(out["alpha"], np.float32),
             occupancy_bits=np.packbits(occ.reshape(-1)),
             aabb=np.asarray(grid.aabb, np.float32),
             **golden_inputs(H), **{k: np.asarray(v) for k, v in c.items()})
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes): alpha mean "
          f"{float(np.mean(out['alpha'])):.4f}, occupied cells {occ.sum()}")


if __name__ == "__main__":
    main()
