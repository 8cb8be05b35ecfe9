"""Render the reference golden image for the PyTorch port.

Renders the JAX flagship path (toy body, Fast-SNARF, voxel+triplane
field, flat-stream render) on the CPU at 96x96 with a reduced deformer
(resolution 32), grid (32) and field (voxel 16, plane 32), numpy-seeded
field params with an opaque sigma bias, and the posed-body shell grid
(0.08 m). Writes the image AND every input the port needs to render the
same frame (camera basis, pose, grid, sizes, param seed) to
``tests/data/torch_slice_golden.npz``. The port renders it in
``tests/test_torch_slice.py`` (CPU) and ``chip_smoke.py`` (GPU).

Run:  JAX_PLATFORMS=cpu python tools/make_torch_golden.py
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

CONFIG = dict(image_hw=96, deformer_res=32, grid_size=32, voxel_res=16,
              plane_res=32, param_seed=0, sigma_bias=100.0,
              shell_margin=0.08)


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


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
    from instantavatar_torch.convert import seeded_field_params
    from instantavatar_tpu.body import toy_smpl_model
    from instantavatar_tpu.deformers import SNARFDeformer
    from instantavatar_tpu.models import VoxelTriplaneField
    from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
    from instantavatar_tpu.train import AvatarModel

    c = CONFIG
    H = c["image_hw"]
    body = toy_smpl_model(bone_rings=3)
    avatar = AvatarModel(
        body, VoxelTriplaneField(voxel_res=c["voxel_res"],
                                 plane_res=c["plane_res"]),
        SNARFDeformer(body, resolution=c["deformer_res"], cano_pose="a_pose",
                      n_iters=6, cand_cap=2, n_init_active=4),
        n_steps=128, k_cap=8, grid_size=c["grid_size"], eval_n_steps=48,
        cache_n_cand=1, eval_grid="smpl_shell",
        shell_margin=c["shell_margin"])
    p = seeded_field_params(c["voxel_res"], c["plane_res"], c["param_seed"],
                            sigma_bias=c["sigma_bias"])
    params = VoxelTriplaneParams(**{
        k: (tuple(map(jnp.asarray, v)) if isinstance(v, list)
            else jnp.asarray(v)) for k, v in p.items()})
    state = avatar.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    state = state._replace(params={**state.params, "field": params})
    batch = {**golden_inputs(H), "near": np.float32(4.0),
             "far": np.float32(6.0)}
    grid = avatar.build_pose_grid(state, batch)
    out = avatar.render_frame(state, batch, grid=grid, image_shape=(H, H))
    occ = np.asarray(grid.occupancy)
    dest = ROOT / "tests" / "data" / "torch_slice_golden.npz"
    dest.parent.mkdir(exist_ok=True)
    np.savez(dest, rgb=np.asarray(out["rgb"], np.float32),
             alpha=np.asarray(out["alpha"], np.float32),
             occupancy_bits=np.packbits(occ.reshape(-1)),
             aabb=np.asarray(grid.aabb, np.float32),
             **golden_inputs(H),
             **{k: np.asarray(v) for k, v in c.items()})
    print(f"wrote {dest} ({dest.stat().st_size} bytes): alpha mean "
          f"{float(np.mean(out['alpha'])):.4f}, occupied cells {occ.sum()}")


if __name__ == "__main__":
    main()
