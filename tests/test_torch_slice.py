"""The port's whole render slice against the JAX package: JAX
``AvatarModel.render_frame`` vs the port's at 48x48 (flat mode, same
converted params, canonical state and shell grid), the committed JAX
golden frame at 96x96, the bake memo, and a jax-free import."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instantavatar_torch
from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.deformers import SNARFDeformer as JaxSNARF
from instantavatar_tpu.models import VoxelTriplaneField as JaxField
from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
from instantavatar_tpu.train import AvatarModel as JaxAvatar
from instantavatar_torch import convert
from instantavatar_torch.body import toy_smpl_model
from instantavatar_torch.data.rays import make_ray_basis
from instantavatar_torch.deformers import SNARFDeformer
from instantavatar_torch.models import VoxelTriplaneField
from instantavatar_torch.train import AvatarModel, RenderSession, TrainState

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

GOLDEN = Path(__file__).parent / "data" / "torch_slice_golden.npz"
RES, GRID, VR, PR = 32, 32, 16, 32
AVATAR_KW = dict(n_steps=128, k_cap=8, grid_size=GRID, eval_n_steps=48,
                 cache_n_cand=1, eval_grid="smpl_shell", shell_margin=0.08)
SNARF_KW = dict(resolution=RES, cano_pose="a_pose", n_iters=6, cand_cap=2,
                n_init_active=4)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _batch(H, yaw=0.5):
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    pose[[46, 49]] = 0.2
    return {"ray_basis": make_ray_basis(K, np.eye(4)),
            "near": np.float32(4.0), "far": np.float32(6.0),
            "betas": np.zeros(10, np.float32), "body_pose": pose,
            "global_orient": np.array([0.0, yaw, 0.0], np.float32),
            "transl": np.array([0.0, 0.15, 5.0], np.float32)}


def _port_avatar(voxel_res, plane_res, res, grid_size, params_np):
    body = toy_smpl_model(bone_rings=3, device="cpu")
    field = VoxelTriplaneField(voxel_res=voxel_res, plane_res=plane_res,
                               device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(params_np))
    return AvatarModel(body, field, SNARFDeformer(
        body, **{**SNARF_KW, "resolution": res}),
        **{**AVATAR_KW, "grid_size": grid_size})


@pytest.fixture(scope="module")
def jax_scene():
    pnp = convert.seeded_field_params(VR, PR, seed=3, sigma_bias=100.0)
    jbody = jax_toy(bone_rings=3)
    jav = JaxAvatar(jbody, JaxField(voxel_res=VR, plane_res=PR),
                    JaxSNARF(jbody, **SNARF_KW), **AVATAR_KW)
    params = VoxelTriplaneParams(**{
        k: (tuple(map(jnp.asarray, v)) if isinstance(v, list)
            else jnp.asarray(v)) for k, v in pnp.items()})
    state = jav.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    state = state._replace(params={**state.params, "field": params})
    return pnp, jav, state


def test_render_frame_matches_jax_48px(jax_scene):
    """Whole slice. Bound: rgb PSNR >= 40 dB and alpha max-abs <= 5e-3
    (the JAX frame ships as float16 and its head is _mlp, the port's the
    fused-kernel numerics; measured 78 dB, alpha 2.6e-4). The port's
    own shell grid must match JAX's to 0.1% of cells."""
    pnp, jav, jstate = jax_scene
    batch = _batch(48)
    jgrid = jav.build_pose_grid(jstate, batch)
    jout = jav.render_frame(jstate, batch, grid=jgrid, image_shape=(48, 48))

    av = _port_avatar(VR, PR, RES, GRID, pnp)
    state = TrainState(
        deformer_cano=convert.snarf_canonical_from_numpy(
            jax.tree.map(np.asarray, jstate.deformer_cano), device="cpu"),
        grid=None, center=torch.as_tensor(np.array(jstate.center)),
        scale=torch.as_tensor(np.array(jstate.scale)))
    grid = convert.grid_state_from_numpy(jax.tree.map(np.asarray, jgrid),
                                         device="cpu")
    own = av.build_pose_grid(state, batch)
    assert (own.occupancy.numpy() != np.asarray(jgrid.occupancy)).mean() \
        <= 1e-3
    out = av.render_frame(state, batch, grid=grid, image_shape=(48, 48))
    rgb, alpha = out["rgb"].numpy(), out["alpha"].numpy()
    assert rgb.shape == (48 * 48, 3) and np.isfinite(rgb).all()
    assert 0.1 < alpha.mean() < 0.9
    assert _psnr(rgb, np.asarray(jout["rgb"])) >= 40.0
    np.testing.assert_allclose(alpha, np.asarray(jout["alpha"]), atol=5e-3)
    np.testing.assert_allclose(out["counter"].numpy(),
                               np.asarray(jout["counter"]))


def test_render_frames_reuses_bake_per_pose(jax_scene):
    """RenderSession bake memo: a turntable (orientation changes, pose
    does not) bakes once and renders what fresh frames render; a new body
    pose re-bakes. Orientation cancels in the bone transforms only up to
    fp32 rounding, so a reused bake's roots sit within the 1e-5 m Broyden
    tolerance of a fresh one's, and the bf16 feature rounding turns that
    into occasional one-ulp flips: rgb max-abs <= 5e-3 and PSNR >= 60 dB
    (measured 1.2e-3)."""
    pnp = jax_scene[0]
    av = _port_avatar(VR, PR, RES, GRID, pnp)
    state = av.init(np.zeros(10, np.float32))
    b0 = _batch(24, yaw=0.0)
    grid = av.build_pose_grid(state, b0)
    frames = [b0, _batch(24, yaw=0.4),
              {**b0, "body_pose": b0["body_pose"] + 0.1}]
    sess = RenderSession()
    streams = [av.render_stream(state, f, grid, (24, 24), sess)
               for f in frames]
    assert [s.baked for s in streams] == [True, False, True]
    seq = list(av.render_frames(state, frames, grid=grid,
                                image_shape=(24, 24)))
    for f, img in zip(frames, seq):
        fresh = av.render_frame(state, f, grid=grid, image_shape=(24, 24))
        np.testing.assert_allclose(img["rgb"].numpy(),
                                   fresh["rgb"].numpy(), atol=5e-3)
        assert _psnr(img["rgb"].numpy(), fresh["rgb"].numpy()) >= 60.0


@pytest.mark.parametrize("block", [2, 3])
def test_five_row_basis_matches_four_row(jax_scene, block):
    """The 5-row pinhole basis [o, b0, bx, by_px, by_blk] with by_blk ==
    by_px is the 4-row basis, for 2- and 3-pixel blocks. The 5-row form
    sums the block-row and pixel-row terms separately (as in JAX), so the
    directions differ by fp32 rounding, which bf16 features can turn into
    one-ulp flips: rgb max-abs <= 5e-3 and PSNR >= 60 dB."""
    pnp = jax_scene[0]
    av = _port_avatar(VR, PR, RES, GRID, pnp)
    av.prepass_block = block
    state = av.init(np.zeros(10, np.float32))
    b4 = _batch(24)
    b5 = {**b4, "ray_basis": np.concatenate([b4["ray_basis"],
                                             b4["ray_basis"][3:]])}
    grid = av.build_pose_grid(state, b4)
    out4 = av.render_frame(state, b4, grid=grid, image_shape=(24, 24))
    out5 = av.render_frame(state, b5, grid=grid, image_shape=(24, 24))
    assert out4["n_samples"] > 0
    np.testing.assert_allclose(out5["rgb"].numpy(), out4["rgb"].numpy(),
                               atol=5e-3)
    assert _psnr(out5["rgb"].numpy(), out4["rgb"].numpy()) >= 60.0


def test_golden_frame_96px():
    """The committed JAX golden (tools/make_torch_golden.py): the port
    builds its own canonical state and renders with the stored grid.
    Bound rgb PSNR >= 40 dB on the CPU (the GPU run in chip_smoke.py
    holds 35 dB); the port's own shell grid matches the stored one to
    0.1% of cells."""
    g = np.load(GOLDEN)
    H = int(g["image_hw"])
    pnp = convert.seeded_field_params(
        int(g["voxel_res"]), int(g["plane_res"]), int(g["param_seed"]),
        sigma_bias=float(g["sigma_bias"]))
    av = _port_avatar(int(g["voxel_res"]), int(g["plane_res"]),
                      int(g["deformer_res"]), int(g["grid_size"]), pnp)
    state = av.init(g["betas"])
    batch = {k: g[k] for k in ("ray_basis", "betas", "body_pose",
                               "global_orient", "transl")}
    G = int(g["grid_size"])
    occ = np.unpackbits(g["occupancy_bits"])[:G ** 3].astype(bool)
    grid = convert.grid_state_from_numpy(
        {"density_cached": np.zeros((G, G, G), np.float32),
         "occupancy": occ.reshape(G, G, G), "aabb": g["aabb"]},
        device="cpu")
    own = av.build_pose_grid(state, batch)
    assert (own.occupancy.numpy().reshape(-1) != occ).mean() <= 1e-3
    out = av.render_frame(state, batch, grid=grid, image_shape=(H, H))
    assert _psnr(out["rgb"].numpy(), g["rgb"]) >= 40.0
    np.testing.assert_allclose(out["alpha"].numpy(), g["alpha"], atol=5e-3)


def test_unported_paths_raise():
    """The dense eval, once refused, now builds (its frames are held
    against JAX in tests/test_torch_eval_modes.py); w_lpips > 0 needs an
    LPIPS module, as in JAX, and with one the model computes the term
    through ``ngp_loss``; an unknown eval grid is refused (the density
    grid itself renders, tests/test_torch_grid.py)."""
    from instantavatar_torch.losses import load_lpips
    body = toy_smpl_model(device="cpu")
    field = VoxelTriplaneField(voxel_res=4, plane_res=4, device="cpu")
    snarf = SNARFDeformer(body, resolution=16)
    dense = AvatarModel(body, field, snarf, eval_sampling="dense")
    assert dense.eval_sampling == "dense" and dense.eval_n_steps == 64
    with pytest.raises(ValueError, match="lpips_fn"):
        AvatarModel(body, field, snarf, loss_weights={"w_lpips": 1.0})
    with pytest.warns(UserWarning, match="RANDOM"):
        lp = load_lpips("vgg", allow_random=True)
    av = AvatarModel(body, field, snarf, loss_weights={"w_lpips": 1.0},
                     lpips_fn=lp)
    assert av._use_ngp_loss and av.lpips_fn is lp
    av = AvatarModel(body, field, snarf, grid_size=8, eval_grid="shell")
    state = av.init(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="eval_grid"):
        av.render_frame(state, _batch(12), image_shape=(12, 12))


def test_import_loads_no_jax():
    """Every module of the port (the entry points included) imports
    without loading jax or the JAX package."""
    mods = [m.name for m in pkgutil.walk_packages(
        instantavatar_torch.__path__, "instantavatar_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not [m for m in sys.modules\n"
            "            if m.startswith('instantavatar_tpu')]\n"
            "print(len(sys.modules))")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)
    assert len(mods) >= 15
    assert {'instantavatar_torch.cli.train', 'instantavatar_torch.cli.animate',
            'instantavatar_torch.cli.novel_view',
            'instantavatar_torch.train.harness'} <= set(mods)
