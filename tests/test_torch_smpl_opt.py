"""The port's SMPL optimization (the refine and fitting flows) against the
JAX package on the CPU: ``SMPLParams``/``lookup_frame``/``tv_loss``, the
frozen-field optimizer with the SMPL Adam, ``ngp_loss``'s depth term, one
grid-update step (deformer version 1, the refine conf's) and one plain
step (version 2 with the depth term, the fitting conf's) with per-frame
SMPL parameters at the training golden's reduced size (NGP field on the
small grid), the refine mode, a zero pose, and checkpoints that carry the
SMPL leaves.

Tolerances: values 1e-6; Adam updates 1e-6 absolute against optax; step
losses 1e-3 relative, per-leaf gradients (field and the batch frame's
global_orient, body_pose, transl) 1.5e-2 L2-relative, the updated grid
exactly (tools/make_torch_train_golden.py)."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantavatar_tpu.losses.nerf_loss import ngp_loss as jax_ngp_loss
from instantavatar_tpu.train.optim import make_optimizer as jax_make_optimizer
from instantavatar_tpu.train.smpl_params import SMPLParams as JaxSMPLParams
from instantavatar_tpu.train.smpl_params import lookup_frame as jax_lookup
from instantavatar_tpu.train.smpl_params import tv_loss as jax_tv_loss
from instantavatar_torch import convert
from instantavatar_torch.data import make_capsule_sequence
from instantavatar_torch.losses import ngp_loss
from instantavatar_torch.train import StepDraws, make_optimizer
from instantavatar_torch.train.harness import (graft, restore_checkpoint,
                                               save_checkpoint)
from instantavatar_torch.train.smpl_params import (SMPLParams, lookup_frame,
                                                   tv_loss)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_ngp_golden as ngp_tool  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C = golden_tool.CONFIG
SMPL_KEYS = ("global_orient", "body_pose", "transl")


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.as_tensor(np.array(a))


def _smpl0(seed: int = 0) -> dict[str, np.ndarray]:
    """The capsule scene's SMPL parameters (3 frames), perturbed so that
    the optimized pose differs from the batches' own."""
    sp = make_capsule_sequence(C["n_frames"], 8, 8, bone_rings=C["bone_rings"],
                               device="cpu")["smpl_params"]
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v, np.float32).copy() for k, v in sp.items()}
    out["transl"] += 0.01 * rng.standard_normal(out["transl"].shape) \
        .astype(np.float32)
    out["body_pose"] += 0.02 * rng.standard_normal(out["body_pose"].shape) \
        .astype(np.float32)
    return out


def test_smpl_params_match_jax():
    """from_arrays/to_arrays round trip (leaf tensors with grad),
    ``lookup_frame`` and ``tv_loss`` against JAX, 1e-6."""
    sp = _smpl0()
    p = SMPLParams.from_arrays(sp, device="cpu")
    assert all(t.is_leaf and t.requires_grad for t in p)
    assert p.betas.shape == (1, 10)
    back = p.to_arrays()
    for k, v in sp.items():
        np.testing.assert_array_equal(back[k], v.reshape(back[k].shape))
    jp = JaxSMPLParams.from_arrays(sp)
    for idx in (0, 2):
        got = lookup_frame(p, np.int32(idx))
        want = jax_lookup(jp, jnp.int32(idx))
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), atol=1e-6)
    np.testing.assert_allclose(float(tv_loss(p).detach()),
                               float(jax_tv_loss(jp)),
                               rtol=1e-6)


def test_freeze_field_and_smpl_adam_match_optax():
    """``make_optimizer(freeze_field=True, smpl_lr=...)``: over three
    updates the field parameters stay bit-identical and keep no Adam
    state, and the SMPL leaves move as optax's update moves them (1e-6
    absolute), also with ``freeze_field`` off."""
    rng = np.random.default_rng(3)
    sp = _smpl0()
    for freeze in (True, False):
        jopt = jax_make_optimizer(1e-2, smpl_lr=1e-3, freeze_field=freeze)
        w0 = rng.normal(size=(4, 3)).astype(np.float32)
        jparams = {"field": {"w": jnp.asarray(w0)},
                   "smpl": JaxSMPLParams.from_arrays(sp)}
        jstate = jopt.init(jparams)
        w = torch.nn.Parameter(_t(w0))
        smpl = SMPLParams.from_arrays(sp, device="cpu")
        opt = make_optimizer(1e-2, smpl_lr=1e-3, freeze_field=freeze).init(
            {"field": [w], "smpl": list(smpl)})
        for _ in range(3):
            g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
            gs = {k: rng.normal(size=np.shape(v)).astype(np.float32)
                  for k, v in jparams["smpl"]._asdict().items()}
            upd, jstate = jopt.update(
                {"field": {"w": jnp.asarray(g["w"])},
                 "smpl": JaxSMPLParams(**{k: jnp.asarray(v)
                                          for k, v in gs.items()})},
                jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            w.grad = _t(g["w"])
            for k, leaf in smpl._asdict().items():
                leaf.grad = _t(gs[k])
            assert opt.step()
            if freeze:
                assert torch.equal(w.detach(), _t(w0))
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(jparams["field"]["w"]),
                                       atol=1e-6)
            for k, leaf in smpl._asdict().items():
                np.testing.assert_allclose(
                    leaf.detach().numpy(),
                    np.asarray(getattr(jparams["smpl"], k)), atol=1e-6,
                    err_msg=k)
        assert (opt.field is None) == freeze
        assert opt.moments("smpl") is not None


def test_ngp_loss_depth_term_matches_jax():
    """``ngp_loss`` with the depth term on a patch stack: every component
    and the input gradients within 1e-6 of JAX; on flat rays the patch
    term is absent, as in JAX; with w_lpips > 0 and an LPIPS module the
    LPIPS term is computed too (held against JAX in
    tests/test_torch_lpips.py)."""
    rng = np.random.default_rng(5)
    pred = {"rgb": rng.random((2, 8, 8, 3), dtype=np.float32),
            "alpha": rng.random((2, 8, 8), dtype=np.float32),
            "depth": rng.uniform(4, 6, (2, 8, 8)).astype(np.float32),
            "weights": rng.random((2, 8, 8, 12), dtype=np.float32) * 0.2}
    tgt = {"rgb": rng.random((2, 8, 8, 3), dtype=np.float32),
           "alpha": (rng.random((2, 8, 8)) > 0.5).astype(np.float32)}
    w = dict(w_rgb=1.0, w_alpha=0.1, w_reg=0.1, w_depth_reg=0.01)
    (_, jl), jg = jax.value_and_grad(
        lambda p: jax_ngp_loss(p, tgt, **w), has_aux=True)(pred)
    tp = {k: _t(v).requires_grad_() for k, v in pred.items()}
    total, tl = ngp_loss(tp, {k: _t(v) for k, v in tgt.items()}, **w)
    total.backward()
    assert set(tl) == set(jl) and "loss_depth_reg" in tl
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   atol=1e-6,
                                   err_msg=k)
    for k in pred:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-6, err_msg=k)
    flat = {k: _t(v.reshape(-1, *v.shape[3:])) for k, v in pred.items()}
    _, fl = ngp_loss(flat, {k: _t(v.reshape(-1, *v.shape[3:]))
                            for k, v in tgt.items()}, **w)
    assert "loss_depth_reg" not in fl
    from instantavatar_torch.losses import load_lpips
    with pytest.warns(UserWarning, match="RANDOM"):
        lp = load_lpips("vgg", allow_random=True)
    # VGG's fifth tap needs >= 16 px: the same patches, upsampled
    up = {k: _t(np.repeat(np.repeat(v, 2, 1), 2, 2)) for k, v in pred.items()}
    tup = {k: _t(np.repeat(np.repeat(v, 2, 1), 2, 2)) for k, v in tgt.items()}
    _, l0 = ngp_loss(up, tup, **w)
    _, ll = ngp_loss(up, tup, lpips_fn=lp, **{**w, "w_lpips": 0.01})
    assert float(ll["loss_lpips"]) > 0
    np.testing.assert_allclose(
        float(ll["loss"]), float(l0["loss"]) + 0.01 * float(ll["loss_lpips"]),
        rtol=1e-6)


def _batches():
    b0, b1 = golden_tool.scene_batches()
    return {**b0, "idx": np.int32(0)}, {**b1, "idx": np.int32(1)}


def _draws(d):
    return StepDraws(_t(d["jitter"]), _t(d["noise"]),
                     None if d.get("grid_jitter") is None
                     else _t(d["grid_jitter"]))


@pytest.fixture(scope="module")
def jax_update():
    """JAX's grid-update step (deformer version 1, the refine conf's) from
    the initial state with per-frame SMPL parameters (perturbed from the
    batches' poses): state, gradients, losses and the grid it leaves."""
    b0, _ = _batches()
    jav = ngp_tool.jax_ngp_avatar(version=1, optimize_smpl=True,
                                  optimizer=jax_make_optimizer(C["lr"],
                                                               smpl_lr=1e-4))
    jst = ngp_tool.jax_ngp_state0(jav, b0["betas"],
                                  JaxSMPLParams.from_arrays(_smpl0()))
    k = jax.random.PRNGKey(C["key0"])
    g, jl, jgrid = jax.jit(jav.grads_and_losses, static_argnums=3)(
        jst, {kk: jnp.asarray(v) for kk, v in b0.items()}, k, True)
    return {"jav": jav, "state": jst, "grads": g, "losses": jl,
            "grid": jgrid, "key": k}


def _jax_bake_rows(jav, jst, batch, grid):
    """The rows JAX's cached-search closure bakes for ``batch`` on
    ``grid`` (the first ``cell_budget`` occupied cells, flat order)."""
    G = jav.grid_size
    cells = np.nonzero(np.asarray(grid.occupancy).reshape(-1))[0][
        :jav.cell_budget]
    ijk = np.stack([cells // (G * G), (cells // G) % G, cells % G], -1)
    aabb = np.asarray(grid.aabb)
    centers = aabb[0] + (ijk + 0.5) / G * (aabb[1] - aabb[0])
    rb = jav._resolve_batch(jst.params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    frame = jav._prepare(jst.deformer_cano, rb)
    net = jav._net_apply(jst.params["field"], jst.center, jst.scale)
    return np.asarray(jav.deformer.bake_packed_cache(
        jst.deformer_cano, frame, jnp.asarray(centers, jnp.float32),
        net_sigma_fn=lambda x: net(x)[1]))


def _check_smpl_step(jav, jst, batch, key, upd, jres, monkeypatch,
                     version, loss_weights=None):
    """The port's step against JAX's result ``jres`` = (grads, losses,
    grid): losses and drift logs, the updated grid, the field's
    gradients; then the SMPL leaves' gradients with the port's bake given
    JAX's rows (see the test's docstring)."""
    g, jl, jgrid = jres
    av = ngp_tool.port_ngp_avatar(version=version, optimize_smpl=True,
                                  loss_weights=loss_weights,
                                  optimizer=make_optimizer(C["lr"],
                                                           smpl_lr=1e-4))
    n = C["num_patch"] * C["patch_size"] ** 2
    draws = _draws(golden_tool.jax_draws(key, n, grid_update=upd))

    def step():
        state = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                               av.field, av, device="cpu")
        return (state,) + av.grads_and_losses(state, batch, draws, upd)
    state, losses, grid = step()
    keys = ["mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy", "loss"]
    keys += [f"drift_{kk}" for kk in SMPL_KEYS]
    keys += ["loss_depth_reg"] if loss_weights else []
    for kk in keys:
        np.testing.assert_allclose(float(losses[kk]), float(jl[kk]),
                                   rtol=golden_tool.LOSS_RTOL, atol=1e-9,
                                   err_msg=kk)
    assert float(losses["drift_transl"]) > 1e-3
    assert float(losses["counter_avg"]) == float(jl["counter_avg"])
    np.testing.assert_array_equal(grid.occupancy.numpy(),
                                  np.asarray(jgrid.occupancy))
    jg = convert.field_params_from_numpy(jax.tree.map(np.asarray, g["field"]))
    for nm, p in av.field.named_parameters():
        assert _rel(p.grad.numpy(), jg[nm].numpy()) \
            <= golden_tool.GRAD_RTOL, nm

    jrows = _jax_bake_rows(jav, jst, batch, grid if upd else jst.grid)
    real = av.deformer.bake_packed_cache

    def with_jax_rows(cano, frame, cells, net_sigma_fn, cell_mask=None):
        rows, sig = real(cano, frame, cells, net_sigma_fn, cell_mask)
        # the training bake: its first len(jrows) cells are JAX's, the
        # rest the static budget's padding
        n = len(jrows)
        if cell_mask is None or int(cell_mask.sum()) != n:
            return rows, sig
        r, j = rows[:n].reshape(-1, 13).numpy(), jrows.reshape(-1, 13)
        assert (r[:, 12] != j[:, 12]).sum() <= 1e-3 * len(r)
        ok = (j[:, 12] > 0.5) & (r[:, 12] > 0.5)
        np.testing.assert_allclose(r[ok, :3], j[ok, :3], atol=1e-4)
        assert (np.abs(r[ok, 3:12] - j[ok, 3:12]).max(-1) > 1e-2).sum() \
            <= 0.005 * ok.sum()
        rows = rows.clone()
        rows[:n] = torch.as_tensor(jrows.copy())
        return rows, sig
    monkeypatch.setattr(av.deformer, "bake_packed_cache", with_jax_rows)
    state, losses, _ = step()
    i = int(batch["idx"])
    want = {kk: np.asarray(getattr(g["smpl"], kk))[i] for kk in SMPL_KEYS}
    scale = np.linalg.norm(np.concatenate(list(want.values())))
    assert scale > 1e-4
    for kk in SMPL_KEYS:
        got = getattr(state.smpl, kk).grad.numpy()
        assert not np.delete(got, i, axis=0).any(), kk
        if np.linalg.norm(want[kk]) > 1e-4 * scale:
            assert _rel(got[i], want[kk]) <= golden_tool.GRAD_RTOL, (
                kk, _rel(got[i], want[kk]))
        else:   # cancelled out (version 1: global orient, translation)
            assert np.abs(got[i] - want[kk]).max() <= 1e-4 * scale, kk


def test_smpl_update_step_matches_jax(jax_update, monkeypatch):
    """``optimize_smpl=True``, the grid-update step (version 1) against
    JAX's with JAX's draws: losses and SMPL drift logs 1e-3 relative, the
    updated grid exactly, the field's gradients 1.5e-2 L2-relative. The
    SMPL leaves' gradients (the batch frame's rows; the other frames'
    are 0) 1.5e-2 L2-relative, except where a leaf's gradient cancels
    out: with version 1 global_orient and transl are ~1e-9 in both (they
    cancel in the world->SMPL transform and the correction reads only
    the bone transforms), held at 1e-4 of the three's norm. For these
    the port's training bake takes JAX's rows:
    the two bakes agree in validity and canonical points (1e-4), but
    Broyden's J_inv, chaotic in fp32, ends up to ~0.1 apart in a few
    cells (<= 0.5% of valid rows; tests/test_torch_deformer.py; and a
    lane's validity may flip, <= 0.1% of lanes), and
    through the pose correction -J_inv dx/dtheta those cells moved
    body_pose's gradient by up to 17% on this scene (0.46% with JAX's
    rows)."""
    b0, _ = _batches()
    j = jax_update
    _check_smpl_step(j["jav"], j["state"], b0, j["key"], True,
                     (j["grads"], j["losses"], j["grid"]), monkeypatch, 1)


def test_smpl_plain_step_matches_jax(jax_update, monkeypatch):
    """A plain step with deformer version 2 and ngp_loss's depth term
    (the fitting conf's) on the grid JAX's update step left, same
    tolerances and the same use of JAX's bake rows for the SMPL
    gradients as the update step."""
    _, b1 = _batches()
    lw = {"w_depth_reg": 0.01}
    jav = ngp_tool.jax_ngp_avatar(version=2, optimize_smpl=True,
                                  loss_weights=lw,
                                  optimizer=jax_make_optimizer(C["lr"],
                                                               smpl_lr=1e-4))
    jst = jax_update["state"]._replace(grid=jax_update["grid"])
    k = jax.random.PRNGKey(C["key1"])
    res = jax.jit(jav.grads_and_losses, static_argnums=3)(
        jst, {kk: jnp.asarray(v) for kk, v in b1.items()}, k, False)
    assert float(res[1]["loss_depth_reg"]) > 0
    _check_smpl_step(jav, jst, b1, k, False, res, monkeypatch, 2, lw)


def _refine_avatar(**kw):
    return ngp_tool.port_ngp_avatar(
        k_cap=16, n_steps=64, optimize_smpl=True,
        optimizer=make_optimizer(1e-2, smpl_lr=1e-3,
                                 freeze_field=kw.get("is_refine", False)),
        **kw)


def _seeded_field(av):
    g = av.field.grid
    av.field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_ngp_params(g.n_levels, g.table_size,
                                  **ngp_tool.STEP_PARAMS)))


def test_refine_freezes_field():
    """Refine mode (``is_refine``, ``freeze_field``): after 5 steps (the
    first with a grid update) the field is bit-identical and holds no
    Adam state, the SMPL leaves moved, the occupancy regularizer was
    computed but not added to the loss, and the sigma noise is off (other
    noise draws give the same step)."""
    av = _refine_avatar(is_refine=True)
    assert av.noise_steps == 0
    _seeded_field(av)
    field0 = {k: v.clone() for k, v in av.field.state_dict().items()}
    b0, b1 = _batches()
    sp = _smpl0()
    state = av.init(b0["betas"], smpl_params=sp)
    gen = torch.Generator().manual_seed(0)
    for i in range(5):
        b = (b0, b1)[i % 2]
        n = int(np.prod(b["rays_o"].shape[:-1]))
        draws = av.draw(gen, n, i == 0)
        if i == 1:   # the sigma noise does not reach the step
            loud = draws._replace(noise=draws.noise * 50 + 3)
            la, _ = av.grads_and_losses(state, b, draws)
            lb, _ = av.grads_and_losses(state, b, loud)
            assert float(la["loss"]) == float(lb["loss"])
        step = av.train_step_update if i == 0 else av.train_step
        state, losses = step(state, b, draws)
        if i == 0:
            assert float(losses["reg_occupancy"]) > 0
            nerf = (losses["mse_loss"] + 0.1 * losses["loss_alpha"]
                    + 0.1 * (losses["reg_alpha"] + losses["reg_density"]))
            np.testing.assert_allclose(float(losses["loss"]), float(nerf),
                                       rtol=1e-6)
    for k, v in av.field.state_dict().items():
        assert torch.equal(v, field0[k]), k
    assert state.opt_state.field is None and state.opt_state.count == 5
    moved = np.abs(state.smpl.transl.detach().numpy() - sp["transl"]).sum()
    assert moved > 0


def test_pose_gradient_finite_at_zero_pose():
    """A grid-update step with every frame at exactly zero body pose and
    global orientation: the SMPL leaves' gradients are finite and the
    batch frame's are not all zero."""
    av = _refine_avatar()
    _seeded_field(av)
    b0, _ = _batches()
    sp = _smpl0()
    sp["body_pose"][:] = 0.0
    sp["global_orient"][:] = 0.0
    state = av.init(b0["betas"], smpl_params=sp)
    gen = torch.Generator().manual_seed(1)
    draws = av.draw(gen, int(np.prod(b0["rays_o"].shape[:-1])), True)
    losses, _ = av.grads_and_losses(state, b0, draws, True)
    assert np.isfinite(float(losses["loss"]))
    for kk in SMPL_KEYS:
        g = getattr(state.smpl, kk).grad
        assert bool(torch.isfinite(g).all()), kk
        assert bool(g[0].abs().max() > 0), kk


def test_checkpoint_carries_smpl(tmp_path):
    """save -> restore gives back the SMPL leaves (in place, so the
    optimizer stays bound) and both groups' Adam moments; ``graft`` takes
    the field, grid, bake and normalization but keeps the fresh state's
    SMPL parameters, optimizer and step."""
    av = _refine_avatar()
    _seeded_field(av)
    b0, _ = _batches()
    state = av.init(b0["betas"], smpl_params=_smpl0())
    gen = torch.Generator().manual_seed(2)
    n = int(np.prod(b0["rays_o"].shape[:-1]))
    state, _ = av.train_step_update(state, b0, av.draw(gen, n, True))
    saved_smpl = {k: v.detach().clone() for k, v in state.smpl._asdict()
                  .items()}
    saved_field = {k: v.clone() for k, v in av.field.state_dict().items()}
    ck = save_checkpoint(tmp_path, state, av.field)
    fresh = av.init(b0["betas"], smpl_params=_smpl0(seed=1))
    leaves = list(fresh.smpl)
    back = restore_checkpoint(ck, fresh, av.field)
    assert all(a is b for a, b in zip(back.smpl, leaves))
    for k, v in back.smpl._asdict().items():
        assert torch.equal(v.detach(), saved_smpl[k]), k
    for group in ("field", "smpl"):
        for a, b in zip(*[o.moments(group) for o in (state.opt_state,
                                                     back.opt_state)]):
            for x, y in zip(a, b):
                assert torch.equal(x, y), group
    assert back.step == 1 and back.opt_state.count == 1
    av.field.init(torch.Generator().manual_seed(9))
    fresh = av.init(b0["betas"], smpl_params=_smpl0(seed=1))
    grafted = graft(ck, fresh, av.field)
    for k, v in av.field.state_dict().items():
        assert torch.equal(v, saved_field[k]), k
    assert grafted.step == 0 and grafted.opt_state.count == 0
    assert torch.equal(grafted.grid.occupancy, state.grid.occupancy)
    np.testing.assert_array_equal(grafted.smpl.transl.detach().numpy(),
                                  _smpl0(seed=1)["transl"])
