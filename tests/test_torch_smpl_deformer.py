"""The port's nearest-vertex SMPLDeformer, smpl_init and the no-prepass
render against the JAX package on the CPU (toy body, numpy-seeded
inputs).

Tolerances: the deformer's outputs 1e-5 (nearest-vertex indices apart
from exact distance ties, validity apart from distances within 1e-6 of
the threshold); the gradient of a scalar of xc with respect to betas and
pose 1e-4 L2-relative; frames >= 40 dB rgb PSNR; a replayed fitting step
(SMPLDeformer, optimize_smpl, LPIPS and depth terms) losses 1e-3
relative, field and SMPL gradients 1.5e-2 L2-relative
(tools/make_torch_train_golden.py); the smpl_init grids cell for cell."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.deformers import smpl_deformer as jax_sd
from instantavatar_tpu.losses import lpips as jax_lpips
from instantavatar_tpu.train.optim import make_optimizer as jax_make_optimizer
from instantavatar_tpu.train.smpl_params import SMPLParams as JaxSMPLParams
from instantavatar_torch import convert
from instantavatar_torch.body import toy_smpl_model
from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
from instantavatar_torch.deformers import SMPLCanonical, SMPLDeformer
from instantavatar_torch.ops import nearest_vertex
from instantavatar_torch.render.raymarcher import Rays
from instantavatar_torch.train import TrainState, make_optimizer
from instantavatar_torch.train.harness import restore_checkpoint, \
    save_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_ngp_golden as ngp_tool  # noqa: E402
import make_torch_smpl_golden as smpl_tool  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

THR = 0.05
SMALL = ngp_tool.SMALL_GRID
SMPL_KEYS = ("betas", "global_orient", "body_pose", "transl")


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _pose(seed):
    rng = np.random.default_rng(seed)
    return {"betas": (0.5 * rng.standard_normal((1, 10))).astype(np.float32),
            "body_pose": (0.3 * rng.standard_normal((1, 69)))
            .astype(np.float32),
            "global_orient": (0.4 * rng.standard_normal((1, 3)))
            .astype(np.float32),
            "transl": np.array([[0.1, 0.2, 4.0]], np.float32)}


ORDER = ("betas", "body_pose", "global_orient", "transl")


@pytest.fixture(scope="module")
def pair():
    """JAX and the port's deformer on the toy body (bone_rings 3), with
    both frames prepared from one numpy-seeded pose."""
    jd = jax_sd.SMPLDeformer(jax_toy(bone_rings=3), threshold=THR)
    td = SMPLDeformer(toy_smpl_model(bone_rings=3, device="cpu"),
                      threshold=THR)
    p = _pose(0)
    jf = jd.prepare(*(jnp.asarray(p[k]) for k in ORDER))
    cano = td.build_canonical(_t(p["betas"]))
    tf = td.prepare(cano, *(_t(p[k]) for k in ORDER))
    return jd, td, p, jf, tf, cano


def _query_pts(verts, seed, n=6000):
    """Points near the posed vertices and across their box."""
    rng = np.random.default_rng(seed)
    near = verts[rng.integers(0, len(verts), n)] \
        + 0.04 * rng.standard_normal((n, 3))
    lo, hi = verts.min(0) - 0.1, verts.max(0) + 0.1
    box = rng.uniform(lo, hi, (n // 2, 3))
    return np.concatenate([near, box]).astype(np.float32)


def test_nearest_vertex_matches_jax(pair):
    """Distances 1e-5; indices equal apart from exact ties."""
    _, _, _, jf, _, _ = pair
    verts = np.asarray(jf.verts_smpl)
    pts = _query_pts(verts, 1)
    jd2, ji = (np.asarray(x) for x in jax_sd.nearest_vertex(
        jnp.asarray(pts), jnp.asarray(verts), chunk=2048))
    td2, ti = nearest_vertex(_t(pts), _t(verts))
    np.testing.assert_allclose(td2.numpy(), jd2, atol=1e-5)
    diff = ti.numpy() != ji
    full = ((pts[:, None] - verts[None]) ** 2).sum(-1)
    assert diff.mean() <= 1e-3
    np.testing.assert_allclose(full[diff, ti.numpy()[diff]],
                               full[diff, ji[diff]], atol=1e-6)


def test_prepare_matches_jax(pair):
    """T_inv, w2s, the SMPL-space vertices and both bboxes; the canonical
    bbox is also the one build_canonical returns."""
    _, _, _, jf, tf, cano = pair
    for k in ("T_inv", "verts_smpl", "w2s", "bbox_canonical",
              "bbox_deformed"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(cano.bbox.numpy(), tf.bbox_canonical)


def test_transform_rays_matches_jax(pair):
    jd, td, _, jf, tf, _ = pair
    from instantavatar_tpu.render.raymarcher import Rays as JaxRays
    rng = np.random.default_rng(2)
    o = rng.standard_normal((50, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    z = np.zeros(50, np.float32)
    jr = jd.transform_rays_w2s(jf, JaxRays(o=jnp.asarray(o), d=jnp.asarray(d),
                                           near=z, far=z))
    tr = td.transform_rays_w2s(tf, Rays(o=_t(o), d=_t(d), near=None,
                                        far=None))
    for k in ("o", "d", "near", "far"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), atol=1e-5,
                                   err_msg=k)


def _agree(td, tf, jf, pts):
    """Points whose nearest vertex is the same in both packages and not
    within 1e-6 of the threshold."""
    d2, ti = nearest_vertex(_t(pts), tf.verts_smpl.detach())
    _, ji = jax_sd.nearest_vertex(jnp.asarray(pts), jf.verts_smpl)
    return (ti.numpy() == np.asarray(ji)) \
        & (np.abs(d2.numpy() - THR ** 2) > 1e-6)


def test_deform_matches_jax(pair):
    """xc and valid of posed points: valid equal away from the
    threshold, xc 1e-5 where the nearest vertex agrees."""
    jd, td, _, jf, tf, _ = pair
    pts = _query_pts(np.asarray(jf.verts_smpl), 3)
    jxc, jv = (np.asarray(x) for x in jd.deform(jf, jnp.asarray(pts)))
    with torch.no_grad():
        txc, tv = td.deform(tf, _t(pts))
    ok = _agree(td, tf, jf, pts)
    assert ok.mean() >= 0.999 and 0.2 < jv.mean() < 0.95
    np.testing.assert_array_equal(tv.numpy()[ok], jv[ok])
    np.testing.assert_allclose(txc.numpy()[ok], jxc[ok], atol=1e-5)


def test_bake_packed_cache_matches_jax(pair):
    """Rows [xc, J_inv, valid] and the per-cell sigma (a closed-form
    sigma in both) on cell centres across the posed box."""
    jd, td, _, jf, tf, cano = pair
    bb = np.asarray(jf.bbox_deformed)
    rng = np.random.default_rng(4)
    cells = rng.uniform(bb[0], bb[1], (4000, 3)).astype(np.float32)
    jrows, jsig = jd.bake_packed_cache(
        (), jf, jnp.asarray(cells), return_sigma=True,
        net_sigma_fn=lambda x: 10 * jnp.sin(3 * x).sum(-1))
    trows, tsig = td.bake_packed_cache(
        cano, tf, _t(cells), lambda x: 10 * torch.sin(3 * x).sum(-1))
    ok = _agree(td, tf, jf, cells)
    assert trows.shape == (4000, 13) and td.cache_K == 1
    np.testing.assert_allclose(trows.numpy()[ok], np.asarray(jrows)[ok],
                               atol=1e-5)
    np.testing.assert_allclose(tsig.numpy()[ok], np.asarray(jsig)[ok],
                               atol=1e-4)


def test_deform_gradients_match_jax(pair):
    """d sum(w * xc) / d (betas, body_pose, global_orient, transl): 1e-4
    L2-relative (the nearest-vertex index takes no gradient). Points in
    SMPL space do not move with the global orientation and translation
    (they cancel between the skinning and the world->SMPL transform), so
    those two gradients are rounding residue (~1e-6 of the others) in
    both, and are held at 1e-4 of the four's norm instead."""
    jd, td, p, jf, _, cano = pair
    pts = _query_pts(np.asarray(jf.verts_smpl), 5, n=3000)
    w = np.random.default_rng(6).standard_normal(pts.shape) \
        .astype(np.float32)

    def jfun(*args):
        xc, v = jd.deform(jd.prepare(*args), jnp.asarray(pts))
        return jnp.sum(jnp.where(v[:, None], xc, 0.0) * w)
    jg = jax.jit(jax.grad(jfun, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(p[k]) for k in ORDER))
    scale = np.linalg.norm(np.concatenate([np.ravel(g) for g in jg]))
    leaves = [_t(p[k]).requires_grad_() for k in ORDER]
    xc, v = td.deform(td.prepare(cano, *leaves), _t(pts))
    (torch.where(v[:, None], xc, torch.zeros_like(xc)) * _t(w)).sum() \
        .backward()
    for k, leaf, g in zip(ORDER, leaves, jg):
        g = np.asarray(g)
        if k in ("betas", "body_pose"):
            assert np.linalg.norm(g) > 1e-3 * scale, k
            assert _rel(leaf.grad.numpy(), g) <= 1e-4, k
        else:
            assert np.abs(leaf.grad.numpy() - g).max() <= 1e-4 * scale, k


# -- frames -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frame_scene():
    """JAX avatar (SMPLDeformer threshold 0.12, NGPField on the small hash
    grid with seeded weights) and its state."""
    jav = smpl_tool.jax_smpl_avatar(grid=SMALL)
    st = jav.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    params = ngp_tool.jax_ngp_params(jav.field.grid, 0, 0.5, 100.0)
    return jav, st._replace(params={**st.params, "field": params})


def _port_frame_avatar():
    av = smpl_tool.port_smpl_avatar(grid=SMALL)
    smpl_tool.seed_port_field(av.field)
    return av


def test_smpl_frame_matches_jax_48px(jax_frame_scene):
    """The SMPL deformer's flat frame (the packed cache of its
    nearest-vertex rows) against JAX's on the same shell grid: >= 40 dB,
    alpha within 5e-3; the port's own shell grid matches JAX's to 0.1% of
    cells."""
    jav, jst = jax_frame_scene
    batch = {**ngp_tool.golden_inputs(48), "near": np.float32(4.0),
             "far": np.float32(6.0)}
    jgrid = jav.build_pose_grid(jst, batch)
    jout = jav.render_frame(jst, batch, grid=jgrid, image_shape=(48, 48))
    av = _port_frame_avatar()
    state = av.init(np.zeros(10, np.float32))
    assert isinstance(state.deformer_cano, SMPLCanonical)
    own = av.build_pose_grid(state, batch)
    assert (own.occupancy.numpy() != np.asarray(jgrid.occupancy)).mean() \
        <= 1e-3
    grid = convert.grid_state_from_numpy(jax.tree.map(np.asarray, jgrid),
                                         device="cpu")
    out = av.render_frame(state, batch, grid=grid, image_shape=(48, 48))
    alpha = out["alpha"].numpy()
    assert 0.1 < alpha.mean() < 0.9
    assert _psnr(out["rgb"].numpy(), np.asarray(jout["rgb"])) >= 40.0
    np.testing.assert_allclose(alpha, np.asarray(jout["alpha"]), atol=5e-3)


def test_smpl_golden_frame():
    """The committed JAX golden (tools/make_torch_smpl_golden.py, default
    hash grid): >= 40 dB on the CPU (the GPU run holds 35 dB)."""
    gold = smpl_tool.render_golden("cpu")
    assert gold["psnr"] >= 40.0
    np.testing.assert_allclose(gold["alpha"], gold["golden_alpha"],
                               atol=5e-3)


def test_odd_size_frame_matches_jax(jax_frame_scene):
    """47 x 49 divides into neither 3- nor 2-pixel blocks: JAX renders it
    with ``prepass_shape = None`` from the batch's per-pixel rays, the
    port with 1-pixel blocks from the pinhole basis; >= 40 dB."""
    jav, jst = jax_frame_scene
    H, W = 47, 49
    f = 2000.0 * H / 540
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    rays_o, rays_d = make_ray_grid(K, np.eye(4), H, W)
    base = ngp_tool.golden_inputs(H)
    n = H * W
    jbatch = {k: base[k] for k in ("betas", "body_pose", "global_orient",
                                   "transl")}
    jbatch.update(rays_o=rays_o.reshape(n, 3), rays_d=rays_d.reshape(n, 3),
                  near=np.full(n, 4.0, np.float32),
                  far=np.full(n, 6.0, np.float32))
    jgrid = jav.build_pose_grid(jst, jbatch)
    jout = jav.render_frame(jst, jbatch, grid=jgrid, image_shape=(H, W))
    av = _port_frame_avatar()
    state = av.init(np.zeros(10, np.float32))
    assert av._block_size(H, W) == 1
    grid = convert.grid_state_from_numpy(jax.tree.map(np.asarray, jgrid),
                                         device="cpu")
    out = av.render_frame(state, {**jbatch, "ray_basis": make_ray_basis(
        K, np.eye(4))}, grid=grid, image_shape=(H, W))
    assert out["rgb"].shape == (n, 3)
    assert 0.05 < float(out["alpha"].mean()) < 0.9
    assert _psnr(out["rgb"].numpy(), np.asarray(jout["rgb"])) >= 40.0


# -- training -----------------------------------------------------------------

def _smpl0():
    from instantavatar_torch.data import make_capsule_sequence
    C = golden_tool.CONFIG
    sp = make_capsule_sequence(C["n_frames"], 8, 8, bone_rings=C["bone_rings"],
                               device="cpu")["smpl_params"]
    rng = np.random.default_rng(0)
    out = {k: np.asarray(v, np.float32).copy() for k, v in sp.items()}
    out["transl"] += 0.01 * rng.standard_normal(out["transl"].shape) \
        .astype(np.float32)
    out["body_pose"] += 0.02 * rng.standard_normal(out["body_pose"].shape) \
        .astype(np.float32)
    return out


def test_fitting_step_matches_jax():
    """One plain fitting step: SMPLDeformer (threshold 0.12),
    ``optimize_smpl`` (betas included), ngp_loss with w_lpips 0.01 (VGG,
    JAX's random trunk carried across) and w_depth_reg 0.01, JAX's draws:
    losses 1e-3 relative (the hard-surface terms, ~0 on this opaque field,
    5e-5 absolute), the field's and the SMPL betas' and body pose's
    gradients 1.5e-2 L2-relative. The global orientation and translation
    cancel in the world->SMPL transform (0 in JAX, rounding residue in the
    port): held at 1e-4 of the four's norm."""
    C = golden_tool.CONFIG
    b1 = {**golden_tool.scene_batches()[1], "idx": np.int32(1)}
    lp = jax_lpips.LPIPSParams(
        convs=jax_lpips._random_trunk("vgg", jax.random.PRNGKey(0)),
        heads=jax_lpips._shipped_heads("vgg"))
    lw = {"w_rgb": 1.0, "w_alpha": 0.1, "w_reg": 0.1, "w_lpips": 0.01,
          "w_depth_reg": 0.01}
    kw = dict(n_steps=C["n_steps"], k_cap=C["k_cap"],
              grid_size=C["grid_size"], noise_steps=C["noise_steps"],
              optimize_smpl=True, loss_weights=lw)
    jav = smpl_tool.jax_smpl_avatar(
        grid=SMALL, lpips_fn=jax_lpips.LPIPS("vgg", lp),
        optimizer=jax_make_optimizer(C["lr"], smpl_lr=1e-4), **kw)
    jst = ngp_tool.jax_ngp_state0(jav, b1["betas"],
                                  JaxSMPLParams.from_arrays(_smpl0()))
    jb = {k: jnp.asarray(v) for k, v in b1.items()}
    # the frame's body shell: the k_cap samples reach the body
    jst = jst._replace(grid=jav.build_pose_grid(jst, jb))
    key = jax.random.PRNGKey(C["key1"])
    g, jl, _ = jax.jit(jav.grads_and_losses, static_argnums=3)(
        jst, jb, key, False)
    av = smpl_tool.port_smpl_avatar(
        grid=SMALL, lpips_fn=convert.lpips_from_numpy(
            jax.tree.map(np.asarray, lp), "vgg"),
        optimizer=make_optimizer(C["lr"], smpl_lr=1e-4), **kw)
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                           av.field, av, device="cpu")
    assert isinstance(state.deformer_cano, SMPLCanonical)
    n = C["num_patch"] * C["patch_size"] ** 2
    d = golden_tool.jax_draws(key, n, grid_update=False)
    from instantavatar_torch.train import StepDraws
    losses, grid = av.grads_and_losses(
        state, b1, StepDraws(_t(d["jitter"]), _t(d["noise"])), False)
    assert grid is state.grid
    for k in ("mse_loss", "loss_alpha", "loss_lpips", "loss_depth_reg",
              "loss", "drift_transl", "drift_body_pose"):
        np.testing.assert_allclose(float(losses[k]), float(jl[k]), rtol=1e-3,
                                   err_msg=k)
    assert float(losses["loss_lpips"]) > 0
    assert float(losses["loss_depth_reg"]) > 0
    for k in ("reg_alpha", "reg_density"):   # ~0: the field is opaque
        np.testing.assert_allclose(float(losses[k]), float(jl[k]),
                                   atol=golden_tool.REG_DENSITY_ATOL,
                                   err_msg=k)
    jg = convert.field_params_from_numpy(jax.tree.map(np.asarray, g["field"]))
    for nm, prm in av.field.named_parameters():
        assert _rel(prm.grad.numpy(), jg[nm].numpy()) <= 1.5e-2, nm
    want = {k: np.asarray(getattr(g["smpl"], k)) for k in SMPL_KEYS}
    scale = np.linalg.norm(np.concatenate([v.ravel() for v in want.values()]))
    for k in SMPL_KEYS:
        got = getattr(state.smpl, k).grad.numpy().reshape(want[k].shape)
        if k in ("betas", "body_pose"):
            assert np.linalg.norm(want[k]) > 1e-3 * scale, k
            assert _rel(got, want[k]) <= 1.5e-2, (k, _rel(got, want[k]))
        else:   # cancelled in the world->SMPL transform (see above)
            assert np.abs(got - want[k]).max() <= 1e-4 * scale, k


# -- smpl_init ------------------------------------------------------------------

SI = dict(n_steps=32, k_cap=8, grid_size=16, noise_steps=0, smpl_init=True)


def test_smpl_init_grids_and_steps_match_jax(tmp_path):
    """The demo's ``smpl_init``: the seeded per-frame grids equal JAX's
    cell for cell (occupancy, density_cached, aabb); a grid-update step
    at step 0 (the 500-step latch keeps the seeded stack) and one at step
    500 (the frame's updated grid goes back into the stack) leave JAX's
    stack, and the batch frame's losses match at 1e-3; a checkpoint
    round-trips the stack and the SMPL canonical state."""
    C = golden_tool.CONFIG
    sp = _smpl0()
    jav = smpl_tool.jax_smpl_avatar(
        grid=SMALL, optimizer=jax_make_optimizer(C["lr"]), **SI)
    assert jav.grid_update_interval == 1
    jst = ngp_tool.jax_ngp_state0(jav, sp["betas"],
                                  JaxSMPLParams.from_arrays(sp))
    av = smpl_tool.port_smpl_avatar(grid=SMALL,
                                    optimizer=make_optimizer(C["lr"]), **SI)
    assert av.grid_update_interval == 1
    with pytest.raises(ValueError, match="smpl_params"):
        av.init(sp["betas"])
    own = av.init(sp["betas"], smpl_params=sp)
    F = sp["body_pose"].shape[0]
    assert own.grid.occupancy.shape == (F, 16, 16, 16)
    fracs = own.grid.occupancy.reshape(F, -1).float().mean(-1).numpy()
    assert (fracs > 0).all() and (fracs < 0.5).all()
    for k in ("occupancy", "density_cached", "aabb"):
        np.testing.assert_array_equal(getattr(own.grid, k).numpy(),
                                      np.asarray(getattr(jst.grid, k)),
                                      err_msg=k)

    b1 = {**golden_tool.scene_batches()[1], "idx": np.int32(1)}
    n = C["num_patch"] * C["patch_size"] ** 2
    gfun = jax.jit(jav.grads_and_losses, static_argnums=3)
    from instantavatar_torch.train import StepDraws
    for step, key in ((0, 21), (500, 22)):
        js = jst._replace(step=jnp.int32(step))
        k = jax.random.PRNGKey(key)
        _, jl, jgrid = gfun(js, {kk: jnp.asarray(v) for kk, v in b1.items()},
                            k, True)
        st = convert.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                            av.field, av, device="cpu")
        d = golden_tool.jax_draws(k, n, c={**C, **SI})
        losses, grid = av.grads_and_losses(
            st, b1, StepDraws(*(_t(d[kk]) for kk in ("jitter", "noise",
                                                     "grid_jitter"))), True)
        for kk in ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
                   "loss"):
            np.testing.assert_allclose(float(losses[kk]), float(jl[kk]),
                                       rtol=1e-3, err_msg=(step, kk))
        for kk in ("occupancy", "density_cached"):
            np.testing.assert_allclose(getattr(grid, kk).numpy(),
                                       np.asarray(getattr(jgrid, kk)),
                                       rtol=1e-5, err_msg=(step, kk))
        same = (grid.occupancy == st.grid.occupancy).reshape(F, -1).all(-1)
        assert same.tolist() == ([True] * F if step == 0
                                 else [i != 1 for i in range(F)]), step

    state = own._replace(step=3)
    ck = save_checkpoint(tmp_path, state, av.field)
    back = restore_checkpoint(ck, av.init(sp["betas"], smpl_params=sp),
                              av.field)
    assert isinstance(back.deformer_cano, SMPLCanonical) and back.step == 3
    for a, b in zip(state.grid + state.deformer_cano,
                    back.grid + back.deformer_cano):
        assert torch.equal(a, b)
    assert isinstance(back, TrainState)
