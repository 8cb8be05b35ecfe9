"""The port's hash-grid NGPField against the JAX package on the CPU:
``hash_encode`` at the default 16 x 2 @ 2^19 grid (slots, features, the
table's and the points' gradients), ``trunc_exp``, ``NGPField.apply`` /
``density`` and their parameter gradients, one NGP update step and one
plain step at the training golden's reduced size with a small hash grid
(``tools/make_torch_ngp_golden.py:SMALL_GRID``), and the committed 48 px
JAX NGP frame.

Tolerances: slot indices exactly; features 1e-6 absolute; the table's
gradient 1e-5 relative (fp32 scatter-adds in another order); the field's
outputs 1e-5; step losses 1e-3 relative and per-leaf gradients 1.5e-2
L2-relative, the updated grid exactly (the training golden's tolerances,
tools/make_torch_train_golden.py); the golden frame >= 40 dB."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.models.ngp import NGPField as JaxNGPField
from instantavatar_tpu.models.ngp import trunc_exp as jax_trunc_exp
from instantavatar_tpu.ops import hashgrid as jax_hashgrid
from instantavatar_torch import convert
from instantavatar_torch.models import NGPField, trunc_exp
from instantavatar_torch.ops import (HashGridConfig, hash_encode, hash_slots,
                                     level_resolutions)
from instantavatar_torch.train import StepDraws

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_ngp_golden as ngp_tool  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C = golden_tool.CONFIG


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.as_tensor(np.array(a))


def _points(n: int = 4096, seed: int = 0) -> np.ndarray:
    """Uniform points in [-0.1, 1.1]^3, with rows exactly at 0, at 1, on
    lattice corners of every level, and partly outside [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[:16] = 0.0
    x[16:32] = 1.0
    res = level_resolutions(HashGridConfig())
    for i, r in enumerate(res):
        k = rng.integers(0, r + 1, (32, 3))
        x[32 + 32 * i:64 + 32 * i] = (k / r).astype(np.float32)
    return x


def _jax_slots(x: np.ndarray, cfg) -> np.ndarray:
    """JAX's per-level slot of each corner, (N, L, 8), from its own
    ``_level_indices`` on its own clamped corner coordinates."""
    xs = jnp.clip(jnp.asarray(x), 0.0, 1.0)
    corners = jnp.asarray(jax_hashgrid._CORNERS)
    out = []
    for r in jax_hashgrid.level_resolutions(cfg):
        base = jnp.clip(jnp.floor(xs * r).astype(jnp.int32), 0, r)
        cidx = jnp.minimum(base[:, None, :] + corners[None], r)
        out.append(np.asarray(jax_hashgrid._level_indices(
            cidx.astype(jnp.uint32), r, cfg.table_size)))
    return np.stack(out, 1).astype(np.int64)


def test_level_resolutions_and_dense_levels():
    """Same resolutions as JAX; at the default grid levels 0-3 are dense
    and 4-15 hashed (their slots exceed the dense range)."""
    cfg = HashGridConfig()
    res = level_resolutions(cfg)
    assert res == jax_hashgrid.level_resolutions(jax_hashgrid.HashGridConfig())
    assert res[:5] == [16, 24, 36, 54, 81] and res[-1] == 7006
    dense = [(r + 1) ** 3 <= cfg.table_size for r in res]
    assert dense == [True] * 4 + [False] * 12
    s = hash_slots(_t(_points()), cfg).numpy()
    assert s.min() >= 0 and s.max() < cfg.table_size
    for lvl, r in enumerate(res[:4]):
        assert s[:, lvl].max() < (r + 1) ** 3


def test_hash_encode_matches_jax():
    """Default grid, 4096 points (0, 1, lattice corners, outside [0, 1]):
    slot indices equal to JAX's exactly on every level; features 1e-6;
    the table's gradient 1e-5 relative and the points' gradient 1e-5
    relative against ``jax.grad`` of a random projection."""
    cfg = HashGridConfig()
    jcfg = jax_hashgrid.HashGridConfig()
    x = _points()
    rng = np.random.default_rng(1)
    table = rng.normal(0.0, 0.1, (16, cfg.table_size, 2)).astype(np.float32)
    np.testing.assert_array_equal(hash_slots(_t(x), cfg).numpy(),
                                  _jax_slots(x, jcfg))
    ct = rng.normal(size=(x.shape[0], 32)).astype(np.float32)

    def jf(tab, xx):
        return jnp.sum(jax_hashgrid.hash_encode(tab, xx, jcfg) * ct)
    jfeat = np.asarray(jax_hashgrid.hash_encode(jnp.asarray(table),
                                                jnp.asarray(x), jcfg))
    jg_tab, jg_x = jax.grad(jf, argnums=(0, 1))(jnp.asarray(table),
                                                jnp.asarray(x))
    tt, xt = _t(table).requires_grad_(), _t(x).requires_grad_()
    feat = hash_encode(tt, xt, cfg)
    np.testing.assert_allclose(feat.detach().numpy(), jfeat, atol=1e-6)
    (feat * _t(ct)).sum().backward()
    assert _rel(tt.grad.numpy(), np.asarray(jg_tab)) <= 1e-5
    assert _rel(xt.grad.numpy(), np.asarray(jg_x)) <= 1e-5
    # row chunks change nothing
    small = hash_encode(_t(table), _t(x), cfg, chunk=1000)
    torch.testing.assert_close(small, feat.detach(), rtol=0, atol=0)


def test_trunc_exp_matches_jax():
    """Value and gradient, inside and outside the clip, 1e-5 relative."""
    x = np.array([-40.0, -15.0, -3.0, 0.0, 2.5, 15.0, 16.0, 30.0],
                 np.float32)
    jy = np.asarray(jax_trunc_exp(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jax_trunc_exp(v) * 1.5))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    y = trunc_exp(xt)
    (y * 1.5).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=1e-5)


def test_ngp_field_matches_jax():
    """``NGPField()`` with JAX's own initial parameters (and a sigma
    bias): ``apply`` for both head names and ``density`` within 1e-5 of
    JAX; the gradient of a projection of colour and sigma with respect to
    every parameter and to the points within 1e-5 relative."""
    jfield = JaxNGPField()
    p = jfield.init(jax.random.PRNGKey(3))
    p = p._replace(sigma_b=(p.sigma_b[0], p.sigma_b[1].at[0].set(2.0)))
    field = NGPField(device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(
        jax.tree.map(np.asarray, p)))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, (2000, 3)).astype(np.float32)
    center = np.array([0.0, -0.3, 0.0], np.float32)
    scale = np.array([2.2, 2.4, 1.6], np.float32)
    cc = rng.normal(size=(2000, 3)).astype(np.float32)
    cs = rng.normal(size=(2000,)).astype(np.float32)

    def jf(params, xx):
        c, s = jfield.apply(params, xx, center, scale)
        return jnp.sum(c * cc) + jnp.sum(s * cs)
    jc, js = jfield.apply(p, jnp.asarray(x), center, scale)
    jd = jfield.density(p, jnp.asarray(x), center, scale)
    jg, jgx = jax.grad(jf, argnums=(0, 1))(p, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    for head in ("fused", "mlp"):
        c, s = field.apply(xt, _t(center), _t(scale), head=head)
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc),
                                   atol=1e-5)
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        field.density(_t(x), _t(center), _t(scale)).detach().numpy(),
        np.asarray(jd), atol=1e-5, rtol=1e-5)
    ((c * _t(cc)).sum() + (s * _t(cs)).sum()).backward()
    want = convert.field_params_from_numpy(jax.tree.map(np.asarray, jg))
    for n, prm in field.named_parameters():
        assert _rel(prm.grad.numpy(), want[n].numpy()) <= 1e-5, n
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) <= 1e-5
    with pytest.raises(ValueError, match="head"):
        field.apply(xt, _t(center), _t(scale), head="bf16")


def _draws(d):
    return StepDraws(_t(d["jitter"]), _t(d["noise"]),
                     None if d.get("grid_jitter") is None
                     else _t(d["grid_jitter"]))


def test_ngp_train_steps_match_jax():
    """``train_step_update`` from JAX's state 0 and ``train_step`` from
    JAX's state 1 (after JAX's update) with an NGP field on the small
    grid and JAX's draws: losses 1e-3 relative (reg_density 5e-5
    absolute), per-leaf gradients 1.5e-2 L2-relative, the updated grid
    exactly, the evaluated-slot counts exactly."""
    b0, b1 = golden_tool.scene_batches()
    jav = ngp_tool.jax_ngp_avatar()
    st = [ngp_tool.jax_ngp_state0(jav, b0["betas"])]
    grads = jax.jit(jav.grads_and_losses, static_argnums=3)
    n = C["num_patch"] * C["patch_size"] ** 2
    av = ngp_tool.port_ngp_avatar()
    names = [k for k, _ in av.field.named_parameters()]
    for i, (b, key, upd) in enumerate(((b0, C["key0"], True),
                                       (b1, C["key1"], False))):
        k = jax.random.PRNGKey(key)
        g, jl, jgrid = grads(st[i], {kk: jnp.asarray(v)
                                     for kk, v in b.items()}, k, upd)
        state = convert.train_state_from_numpy(
            jax.tree.map(np.asarray, st[i]), av.field, av, device="cpu")
        step = av.train_step_update if upd else av.train_step
        new, losses = step(state, b, _draws(golden_tool.jax_draws(
            k, n, grid_update=upd)))
        for kk in ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
                   "loss"):
            np.testing.assert_allclose(float(losses[kk]), float(jl[kk]),
                                       rtol=golden_tool.LOSS_RTOL, atol=1e-9,
                                       err_msg=f"step {i} {kk}")
        np.testing.assert_allclose(float(losses["reg_density"]),
                                   float(jl["reg_density"]),
                                   atol=golden_tool.REG_DENSITY_ATOL)
        assert float(losses["counter_avg"]) == float(jl["counter_avg"])
        jg = convert.field_params_from_numpy(jax.tree.map(np.asarray,
                                                          g["field"]))
        rels = {nm: _rel(p.grad.numpy(), jg[nm].numpy())
                for nm, p in zip(names, av.field.parameters())}
        assert max(rels.values()) <= golden_tool.GRAD_RTOL, (i, rels)
        np.testing.assert_array_equal(new.grid.occupancy.numpy(),
                                      np.asarray(jgrid.occupancy))
        if i == 0:
            assert 0 < int(new.grid.occupancy.sum()) < C["grid_size"] ** 3
            st.append(jav.apply_grads(st[0], g, jgrid))


def test_ngp_golden_cpu():
    """The committed JAX frame (tools/make_torch_ngp_golden.py: default
    hash grid, 48 px, shell grid) rendered by the port: >= 40 dB, alpha
    within 5e-3."""
    r = ngp_tool.render_golden("cpu")
    assert 0.1 < float(r["golden_alpha"].mean()) < 0.9
    assert r["psnr"] >= 40.0, r["psnr"]
    np.testing.assert_allclose(r["alpha"], r["golden_alpha"], atol=5e-3)
