"""The triplane and mlp fields against the JAX package: ``TriPlaneField``
and ``VanillaNeRF`` forward and gradients on converted params (mirroring
tests/test_fields.py:138-147), the positional encoding, a training step of
an ``AvatarModel`` with a ``TriPlaneField`` (with ``use_noise=False``) on
JAX's draws, and a 48 px frame of it, against JAX's
``AvatarModel(body, TriPlaneField(...))``."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_torch import convert
from instantavatar_torch.models import (TriPlaneField, VanillaNeRF,
                                        positional_encoding)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_train_golden as golden_tool  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

FEATS, RES = 8, 32


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _triplane_numpy(seed, sigma_bias=None, std=1.0):
    """TriPlaneParams fields from a numpy seed: N(0, std^2) planes (C, H,
    W), He-init MLPs, zero biases, optional raw-sigma bias."""
    rng = np.random.default_rng(seed)

    def mlp(dims):
        return ([(rng.standard_normal((a, b)) * np.sqrt(2 / a))
                 .astype(np.float32) for a, b in zip(dims[:-1], dims[1:])],
                [np.zeros(b, np.float32) for b in dims[1:]])
    out = {k: (std * rng.standard_normal((FEATS, RES, RES)))
           .astype(np.float32) for k in ("plane_xy", "plane_xz", "plane_yz")}
    out["sigma_w"], out["sigma_b"] = mlp((3 * FEATS, 64, 16))
    out["color_w"], out["color_b"] = mlp((15, 64, 64, 3))
    if sigma_bias is not None:
        out["sigma_b"][-1][0] = sigma_bias
    return out


def _jax_triplane(pnp):
    from instantavatar_tpu.models.triplane import TriPlaneParams
    return TriPlaneParams(**{k: (tuple(map(jnp.asarray, v))
                                 if isinstance(v, list) else jnp.asarray(v))
                             for k, v in pnp.items()})


def test_positional_encoding_matches_jax():
    """[x, sin, cos] per octave in JAX's order, within 1e-6."""
    from instantavatar_tpu.models import positional_encoding as jpe
    x = np.random.default_rng(0).uniform(-1, 1, (17, 3)).astype(np.float32)
    for m in (4, 10):
        np.testing.assert_allclose(positional_encoding(_t(x), m).numpy(),
                                   np.asarray(jpe(jnp.asarray(x), m)),
                                   atol=1e-6)


def test_triplane_forward_and_grad_match_jax():
    """TriPlaneField on converted params, points inside and outside the
    box: colour and sigma within 1e-5 (fp32 both), and the gradients of
    a weighted sum of both with respect to every parameter and to the
    points within 1e-4 relative."""
    from instantavatar_tpu.models import TriPlaneField as JaxTriPlane
    pnp = _triplane_numpy(1)
    jf = JaxTriPlane(features=FEATS, res=RES)
    jp = _jax_triplane(pnp)
    f = TriPlaneField(features=FEATS, res=RES, device="cpu")
    f.load_state_dict(convert.triplane_params_from_numpy(pnp))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.1, 1.1, (65, 3)).astype(np.float32)
    center, scale = np.zeros(3, np.float32), np.full(3, 2.0, np.float32)
    wc = rng.standard_normal((65, 3)).astype(np.float32)
    ws = rng.standard_normal(65).astype(np.float32)

    def jloss(p, xx):
        c, s = jf.apply(p, xx, center, scale)
        return jnp.sum(c * wc) + jnp.sum(s * ws)
    jc, js = jf.apply(jp, x, center, scale)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    c, s = f.apply(xt, _t(center), _t(scale), head="mlp")
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), atol=1e-5)
    ((c * _t(wc)).sum() + (s * _t(ws)).sum()).backward()
    want = convert.triplane_params_from_numpy(jax.tree.map(np.asarray, jg))
    for n, p in f.named_parameters():
        assert _rel(p.grad.numpy(), want[n].numpy()) <= 1e-4, n
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) <= 1e-4
    with torch.no_grad():   # the fused head name evaluates the same fp32 MLP
        c2, s2 = f.apply(_t(x), _t(center), _t(scale), head="fused")
    torch.testing.assert_close(c2, c.detach(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="voxel"):
        convert.triplane_params_from_numpy({**pnp, "voxel": pnp["plane_xy"]})


@pytest.mark.parametrize("use_viewdir", [False, True])
def test_vanilla_nerf_matches_jax(use_viewdir):
    """VanillaNeRF (width 64, the skip at layer 5, sigma ReLU, optional
    view branch) on converted params against JAX's apply: outputs within
    1e-5, parameter and input gradients within 1e-4 relative; a missing
    view direction raises as in JAX."""
    from instantavatar_tpu.models import VanillaNeRF as JaxNeRF
    jnet = JaxNeRF(use_viewdir=use_viewdir, width=64)
    jp = jnet.init(jax.random.PRNGKey(3))
    net = VanillaNeRF(use_viewdir=use_viewdir, width=64, device="cpu")
    net.load_state_dict(convert.vanilla_nerf_params_from_numpy(
        jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (33, 3)).astype(np.float32)
    d = rng.standard_normal((33, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dd = d if use_viewdir else None

    def jloss(p, xx):
        c, s = jnet.apply(p, xx, dd)
        return jnp.sum(c) + jnp.sum(s * 0.1)
    jc, js = jnet.apply(jp, x, dd)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    c, s = net.apply(xt, None if dd is None else _t(dd))
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), atol=1e-5)
    assert float(s.detach().min()) >= 0.0
    (c.sum() + (s * 0.1).sum()).backward()
    want = convert.vanilla_nerf_params_from_numpy(
        jax.tree.map(np.asarray, jg))
    for n, p in net.named_parameters():
        assert _rel(p.grad.numpy(), want[n].numpy()) <= 1e-4, n
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) <= 1e-4
    if use_viewdir:
        with pytest.raises(ValueError, match="view directions"):
            net.apply(_t(x))


# -- the triplane field in an AvatarModel ---------------------------------------

@pytest.fixture(scope="module")
def triplane_case():
    """JAX's AvatarModel(body, TriPlaneField(8, 32)) with use_noise=False
    in the train golden's configuration, its state 0 with seeded triplane
    params, and its grid-update step on the golden's first batch."""
    from instantavatar_tpu.models import TriPlaneField as JaxTriPlane
    c = golden_tool.CONFIG
    b0, _ = golden_tool.scene_batches()
    jav = golden_tool.jax_avatar(use_noise=False)
    jav.field = JaxTriPlane(features=FEATS, res=RES)
    pnp = _triplane_numpy(5, sigma_bias=20.0, std=0.1)
    st = jav.init(jax.random.PRNGKey(0), jnp.asarray(b0["betas"])[None])
    params = {**st.params, "field": _jax_triplane(pnp)}
    st = st._replace(params=params, opt_state=jav.optimizer.init(params))
    key = jax.random.PRNGKey(c["key0"])
    g, losses, grid = jax.jit(jav.grads_and_losses, static_argnums=3)(
        st, {k: jnp.asarray(v) for k, v in b0.items()}, key, True)
    n = c["num_patch"] * c["patch_size"] ** 2
    return dict(jav=jav, state=st, batch=b0, grads=g, losses=losses,
                grid=grid, draws=golden_tool.jax_draws(key, n), pnp=pnp)


def _port_triplane_avatar(**kw):
    from instantavatar_torch.train import AvatarModel
    av = golden_tool.port_avatar(**kw)
    return AvatarModel(av.body, TriPlaneField(features=FEATS, res=RES,
                                              device="cpu"),
                       av.deformer, n_steps=av.n_steps, k_cap=av.k_cap,
                       grid_size=av.grid_size,
                       grid_update_interval=av.grid_update_interval,
                       noise_steps=golden_tool.CONFIG["noise_steps"],
                       optimizer=av.optimizer, **kw)


def test_triplane_train_step_matches_jax(triplane_case):
    """One grid-update step of the triplane avatar with use_noise=False
    (noise_steps 0 in both packages, JAX's noise draws passed in and not
    applied), from JAX's state 0 with JAX's draws: the loss components
    within the train golden's 1e-3, every per-leaf gradient within its
    1.5e-2 relative, the updated grid exactly; with use_noise=True the
    same draws move the loss."""
    from instantavatar_torch.train import StepDraws
    tc = triplane_case
    av = _port_triplane_avatar(use_noise=False)
    assert av.noise_steps == tc["jav"].noise_steps == 0
    st0 = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, tc["state"]), av.field, av, device="cpu")
    d = tc["draws"]
    draws = StepDraws(_t(d["jitter"]), _t(d["noise"]), _t(d["grid_jitter"]))
    st1, losses = av.train_step_update(st0, tc["batch"], draws)
    for k in ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
              "loss"):
        np.testing.assert_allclose(float(losses[k]), float(tc["losses"][k]),
                                   rtol=golden_tool.LOSS_RTOL, atol=1e-9,
                                   err_msg=k)
    jg = convert.triplane_params_from_numpy(
        jax.tree.map(np.asarray, tc["grads"]["field"]))
    rels = {n: _rel(p.grad.numpy(), jg[n].numpy())
            for n, p in av.field.named_parameters()}
    assert max(rels.values()) <= golden_tool.GRAD_RTOL, rels
    np.testing.assert_array_equal(st1.grid.occupancy.numpy(),
                                  np.asarray(tc["grid"].occupancy))

    noisy = _port_triplane_avatar(use_noise=True)
    assert noisy.noise_steps == golden_tool.CONFIG["noise_steps"]
    st0 = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, tc["state"]), noisy.field, noisy,
        device="cpu")
    _, nl = noisy.train_step_update(st0, tc["batch"], draws)
    assert abs(float(nl["loss"]) - float(losses["loss"])) > 1e-6


def test_triplane_frame_matches_jax(triplane_case):
    """A 48 px flat frame of the opaque seeded triplane avatar: rgb PSNR
    >= 40 dB against JAX's (same params, canonical state and shell grid;
    JAX's frame ships as float16), alpha within 5e-3."""
    from instantavatar_torch.data.rays import make_ray_basis
    from instantavatar_torch.train import TrainState
    tc = triplane_case
    jav, jst = tc["jav"], tc["state"]
    jav.eval_grid = "smpl_shell"
    H = 48
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "near": np.float32(4.0), "far": np.float32(6.0),
             "betas": np.asarray(tc["batch"]["betas"]), "body_pose": pose,
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    jgrid = jav.build_pose_grid(jst, batch)
    jout = jav.render_frame(jst, batch, grid=jgrid, image_shape=(H, H))
    av = _port_triplane_avatar(use_noise=False)
    av.field.load_state_dict(convert.triplane_params_from_numpy(tc["pnp"]))
    av.eval_grid = "smpl_shell"
    state = TrainState(
        deformer_cano=convert.snarf_canonical_from_numpy(
            jax.tree.map(np.asarray, jst.deformer_cano), device="cpu"),
        grid=None, center=_t(jst.center), scale=_t(jst.scale))
    grid = convert.grid_state_from_numpy(jax.tree.map(np.asarray, jgrid),
                                         device="cpu")
    out = av.render_frame(state, batch, grid=grid, image_shape=(H, H))
    rgb, alpha = out["rgb"].numpy(), out["alpha"].numpy()
    assert np.isfinite(rgb).all() and 0.02 < alpha.mean() < 0.95
    mse = float(np.mean((rgb.astype(np.float64) - np.asarray(jout["rgb"]))
                        ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-30)) >= 40.0
    np.testing.assert_allclose(alpha, np.asarray(jout["alpha"]), atol=5e-3)
