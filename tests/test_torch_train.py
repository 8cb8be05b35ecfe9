"""The port's training step against the JAX package on the CPU: the dense
compositor, the marcher, the losses and the optimizer update one by one,
then one ``train_step_update`` and one ``train_step`` at reduced size
(SNARF res 32, grid 32, voxel 16, plane 32, 2 x 16^2 patches, the
flagship's n_steps/k_cap/noise/schedule) with JAX's own random draws
passed in, the committed training golden, a binding ``cell_budget``, the
bake's candidate sort, and a 30-step run that learns.

Tolerances: losses 1e-3 relative; per-leaf gradients 1.5e-2 relative in
the L2 norm (bf16 cotangent rounding at ``_mlp``'s casts in another order
than XLA's, and JAX's bf16 scatter-add onto the packed rows against the
port's fp32 one; measured <= 9.2e-3); the updated occupancy grid exactly; the Adam update 1e-6
absolute against optax on identical gradients."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantavatar_tpu.losses.nerf_loss import nerf_loss as jax_nerf_loss
from instantavatar_tpu.render.compositing import composite as jax_composite
from instantavatar_tpu.render.raymarcher import Rays as JaxRays
from instantavatar_tpu.render.raymarcher import render_rays as jax_render_rays
from instantavatar_tpu.train.optim import make_optimizer as jax_make_optimizer
from instantavatar_torch import convert
from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                      make_capsule_sequence)
from instantavatar_torch.losses import hard_surface_reg, nerf_loss
from instantavatar_torch.models import mlp_head
from instantavatar_torch.render import Rays, composite, render_rays
from instantavatar_torch.train import StepDraws, make_optimizer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_train_golden as golden_tool  # noqa: E402

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C = golden_tool.CONFIG
# see tools/make_torch_train_golden.py for why each is what it is
LOSS_RTOL = golden_tool.LOSS_RTOL                # 1e-3
REG_DENSITY_ATOL = golden_tool.REG_DENSITY_ATOL  # 5e-5
GRAD_RTOL = golden_tool.GRAD_RTOL                # 1.5e-2


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.as_tensor(np.array(a))


# -- pieces -----------------------------------------------------------------

def test_composite_matches_jax():
    """Outputs and d(sum rgb + depth + alpha)/d(sigma, rgb), atol 1e-5."""
    rng = np.random.default_rng(0)
    N, S = 64, 24
    sigma = rng.normal(5.0, 20.0, (N, S)).astype(np.float32)
    rgb = rng.random((N, S, 3), dtype=np.float32)
    z = np.sort(rng.uniform(4, 6, (N, S)), -1).astype(np.float32)
    delta = rng.uniform(0.01, 0.05, (N, 1)).astype(np.float32)
    valid = rng.random((N, S)) < 0.7
    bg = rng.random((N, 3), dtype=np.float32)

    def jf(s, c):
        o = jax_composite(s, c, z, delta, valid, bg)
        return o.rgb.sum() + o.depth.sum() + o.alpha.sum(), o
    (_, jo), (jgs, jgc) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(sigma, rgb)
    ts, tc = _t(sigma).requires_grad_(), _t(rgb).requires_grad_()
    to = composite(ts, tc, _t(z), _t(delta), _t(valid), _t(bg))
    (to.rgb.sum() + to.depth.sum() + to.alpha.sum()).backward()
    for k in ("rgb", "depth", "alpha", "weights", "trans"):
        np.testing.assert_allclose(getattr(to, k).detach().numpy(),
                                   np.asarray(getattr(jo, k)), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), atol=1e-5)


def _analytic_field(x, xp):
    """Same arithmetic on jax and torch arrays: a soft ball with colour."""
    r2 = x[:, 0] ** 2 + (x[:, 1] - 0.1) ** 2 + x[:, 2] ** 2
    sigma = 60.0 * (0.3 - r2) / 0.3
    rgb = xp.stack([0.5 + 0.4 * x[:, 0], 0.5 + 0.3 * x[:, 1],
                    0.5 - 0.2 * x[:, 2]], -1)
    return rgb, sigma, r2 < 0.35


def test_render_rays_matches_jax():
    """Dense march with occupancy, compaction to k_cap slots, the -1e3
    fill and sigma noise, JAX's draws passed in: rgb/depth/alpha/weights
    atol 1e-4 (fp32 sample positions), counters exact."""
    rng = np.random.default_rng(1)
    N, S, K = 128, 64, 16
    o = np.tile(np.array([0.0, 0.05, -2.5], np.float32), (N, 1))
    d = rng.normal((0, 0, 1), (0.15, 0.15, 0.0), (N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full(N, 1.5, np.float32), np.full(N, 3.5, np.float32)
    aabb = np.array([[-0.7, -0.6, -0.7], [0.7, 0.8, 0.7]], np.float32)
    key = jax.random.PRNGKey(3)
    k_jitter, k_noise = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_jitter, (N, S)))
    noise = np.asarray(jax.random.normal(k_noise, (N, K)))

    def occ(x, xp):
        return (xp.abs(x) < 0.65).all(-1) if xp is jnp else \
            (x.abs() < 0.65).all(-1)
    jo = jax_render_rays(lambda x: _analytic_field(x, jnp),
                         JaxRays(o, d, near, far),
                         occupancy_fn=lambda x: occ(x, jnp), aabb=aabb,
                         n_steps=S, k_cap=K, key=key, noise_std=0.7)
    to = render_rays(lambda x: _analytic_field(x, torch),
                     Rays(_t(o), _t(d), _t(near), _t(far)),
                     occupancy_fn=lambda x: occ(x, torch), aabb=_t(aabb),
                     n_steps=S, k_cap=K, jitter=_t(jitter), noise=_t(noise),
                     noise_std=0.7)
    assert 0.2 < float(jo.alpha.mean()) < 0.95
    for k in ("rgb", "depth", "alpha", "weights"):
        np.testing.assert_allclose(getattr(to, k).numpy(),
                                   np.asarray(getattr(jo, k)), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(to.counter.numpy(), np.asarray(jo.counter))


def test_nerf_loss_matches_jax():
    """Components rtol 1e-5 except reg terms atol 1e-6 (cancellation),
    input gradients atol 1e-7."""
    rng = np.random.default_rng(2)
    pred = {"rgb": rng.random((2, 8, 8, 3), dtype=np.float32),
            "alpha": rng.random((2, 8, 8), dtype=np.float32),
            "weights": rng.random((2, 8, 8, 12), dtype=np.float32) * 0.2}
    tgt = {"rgb": rng.random((2, 8, 8, 3), dtype=np.float32),
           "alpha": (rng.random((2, 8, 8)) > 0.5).astype(np.float32)}
    (jtot, jl), jg = jax.value_and_grad(
        lambda p: jax_nerf_loss(p, tgt), has_aux=True)(pred)
    tp = {k: _t(v).requires_grad_() for k, v in pred.items()}
    ttot, tl = nerf_loss(tp, {k: _t(v) for k, v in tgt.items()})
    ttot.backward()
    for k in ("mse_loss", "loss_alpha", "loss"):
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5)
    for k in ("reg_alpha", "reg_density"):
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), atol=1e-6)
    for k in pred:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-7, err_msg=k)


def test_optimizer_update_matches_optax():
    """Grouped Adam (betas 0.9/0.99, eps 1e-15, the epoch decay crossing
    an epoch boundary) and apply_if_finite on identical gradients: every
    update atol 1e-6 against optax, including gradients of 1e-12 (Adam's
    sign-like first steps), a skipped non-finite step that leaves the
    count alone, and the give-up after ``skip_nonfinite`` non-finite
    steps in a row, where optax applies the NaN update."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 4), "b": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    jopt = jax_make_optimizer(1e-2, max_epochs=4, steps_per_epoch=2,
                              skip_nonfinite=2)
    jparams = {"field": {k: jnp.asarray(v) for k, v in p0.items()},
               "smpl": ()}
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(_t(p0[k])) for k in shapes]
    topt = make_optimizer(1e-2, max_epochs=4, steps_per_epoch=2,
                          skip_nonfinite=2).init({"field": tparams,
                                                  "smpl": []})
    finite_steps = 6
    plan = ["ok"] * 3 + ["nan"] + ["ok"] * 3 + ["nan"] * 3
    for i, kind in enumerate(plan):
        g = {k: (rng.normal(size=s) * (1e-12 if i == 0 else 1.0))
             .astype(np.float32) for k, s in shapes.items()}
        if kind == "nan":
            g["b"][0] = np.nan
        upd, jstate = jopt.update(
            {"field": {k: jnp.asarray(v) for k, v in g.items()},
             "smpl": ()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, shapes):
            p.grad = _t(g[k])
        before = [p.detach().clone() for p in tparams]
        applied = topt.step()
        assert applied == (kind == "ok" or i == len(plan) - 1), i
        for p, b, k in zip(tparams, before, shapes):
            np.testing.assert_allclose(
                (p.detach() - b).numpy(), np.asarray(upd["field"][k]),
                atol=1e-6, err_msg=f"step {i} leaf {k}")
    assert topt.count == finite_steps + 1
    assert np.isnan(tparams[1].detach().numpy()[0])


# -- the training step ------------------------------------------------------

def _draws(d):
    return StepDraws(_t(d["jitter"]), _t(d["noise"]),
                     None if d.get("grid_jitter") is None
                     else _t(d["grid_jitter"]))


@pytest.fixture(scope="module")
def jax_case():
    """JAX state 0, the two batches, and JAX's two steps (state 0 with
    the grid update, then state 1 plain)."""
    b0, b1 = golden_tool.scene_batches()
    jav = golden_tool.jax_avatar()
    st0 = golden_tool.jax_state0(jav, b0["betas"])
    grads = jax.jit(jav.grads_and_losses, static_argnums=3)
    n = C["num_patch"] * C["patch_size"] ** 2
    out = {"jav": jav, "batches": (b0, b1), "grads": grads, "states": [st0]}
    for i, (b, key, upd) in enumerate(((b0, C["key0"], True),
                                       (b1, C["key1"], False))):
        k = jax.random.PRNGKey(key)
        g, losses, grid = grads(out["states"][i],
                                {kk: jnp.asarray(v) for kk, v in b.items()},
                                k, upd)
        out[f"step{i}"] = (g, losses, grid, golden_tool.jax_draws(
            k, n, grid_update=upd))
        if i == 0:
            out["states"].append(jav.apply_grads(st0, g, grid))
    return out


def _port_state(jax_state, av):
    return convert.train_state_from_numpy(jax.tree.map(np.asarray, jax_state),
                                          av.field, av, device="cpu")


def _check_step(av, losses, jlosses, jgrads, where):
    names = [n for n, _ in av.field.named_parameters()]
    jg = convert.field_params_from_numpy(jgrads)
    for k in ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
              "loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=LOSS_RTOL, atol=1e-9,
                                   err_msg=f"{where} {k}")
    np.testing.assert_allclose(float(losses["reg_density"]),
                               float(jlosses["reg_density"]),
                               atol=REG_DENSITY_ATOL, err_msg=where)
    assert float(losses["counter_avg"]) == float(jlosses["counter_avg"])
    rels = {n: _rel(p.grad.numpy(), jg[n].numpy())
            for n, p in zip(names, av.field.parameters())}
    assert max(rels.values()) <= GRAD_RTOL, (where, rels)


def test_train_steps_match_jax(jax_case):
    """``train_step_update`` from JAX's state 0 (grid update, occupancy
    regularizer, cached-search render) and ``train_step`` from JAX's state
    1, each with JAX's draws: losses, per-leaf gradients, the updated grid
    (exactly), and reg_density against float64. Also that the converted
    optimizer state applies JAX's update: the port's Adam fed JAX's
    gradients moves the params as optax did (atol 1e-6)."""
    av = golden_tool.port_avatar()
    st0 = _port_state(jax_case["states"][0], av)
    g0, jl0, jgrid1, d0 = jax_case["step0"]
    b0, b1 = jax_case["batches"]
    st1, losses = av.train_step_update(st0, b0, _draws(d0))
    _check_step(av, losses, jl0, jax.tree.map(np.asarray, g0["field"]),
                "update step")
    np.testing.assert_array_equal(st1.grid.occupancy.numpy(),
                                  np.asarray(jgrid1.occupancy))
    np.testing.assert_allclose(st1.grid.density_cached.numpy(),
                               np.asarray(jgrid1.density_cached),
                               rtol=1e-4, atol=1e-4)
    assert st1.step == 1 and st1.opt_state.count == 1

    # the port's Adam on JAX's gradients == optax's step 0 -> 1
    jst1 = jax_case["states"][1]
    st0 = _port_state(jax_case["states"][0], av)
    jg = convert.field_params_from_numpy(
        jax.tree.map(np.asarray, g0["field"]))
    for n, p in av.field.named_parameters():
        p.grad = jg[n].clone()
    av.apply_grads(st0, st0.grid)
    want = convert.field_params_from_numpy(
        jax.tree.map(np.asarray, jst1.params["field"]))
    for n, p in av.field.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, err_msg=n)

    g1, jl1, _, d1 = jax_case["step1"]
    st1 = _port_state(jst1, av)
    assert st1.opt_state.count == 1 and st1.step == 1
    _, losses = av.train_step(st1, b1, _draws(d1))
    _check_step(av, losses, jl1, jax.tree.map(np.asarray, g1["field"]),
                "plain step")

    # the port's hard-surface term is the float64 value of its formula
    pred = av.render(st1, b1, grid=st1.grid, draws=_draws(d1),
                     noise_std=1.0)
    w = pred["weights"].detach()
    np.testing.assert_allclose(float(hard_surface_reg(w)),
                               float(hard_surface_reg(w.double())),
                               rtol=1e-4)


def test_cell_budget_binding_matches_jax(jax_case):
    """A cell_budget below the occupied-cell count: the cached-search
    closure bakes only the first ``cell_budget`` occupied cells in flat
    order (JAX's ``nonzero(size=...)``) and samples in the other cells are
    invalid. Plain step from JAX's state 1 against a JAX model with the
    same budget."""
    budget = 1024
    jst1 = jax_case["states"][1]
    assert int(np.asarray(jst1.grid.occupancy).sum()) > 2 * budget
    jav = golden_tool.jax_avatar(cell_budget=budget)
    b1 = jax_case["batches"][1]
    k = jax.random.PRNGKey(C["key1"])
    g, jl, _ = jax.jit(jav.grads_and_losses, static_argnums=3)(
        jst1, {kk: jnp.asarray(v) for kk, v in b1.items()}, k, False)
    av = golden_tool.port_avatar(cell_budget=budget)
    st1 = _port_state(jst1, av)
    _, losses = av.train_step(st1, b1, _draws(jax_case["step1"][3]))
    _check_step(av, losses, jl, jax.tree.map(np.asarray, g["field"]),
                "budget step")
    # the budget removed samples the full bake keeps
    assert float(jl["counter_avg"]) == float(
        jax_case["step1"][1]["counter_avg"])   # marcher slots: same
    full = jax_case["step1"][1]
    assert abs(float(jl["mse_loss"]) - float(full["mse_loss"])) > 1e-4


def test_bake_sort_head_does_not_change_the_step(jax_case):
    """The cache bake orders each cell's K candidates by a no-grad sigma
    (the fused head); the closure then takes the max-sigma candidate over
    all K, so sorting by the ``_mlp`` head instead gives the same loss and
    gradients (rtol 1e-6)."""
    av = golden_tool.port_avatar()
    b1 = jax_case["batches"][1]
    d1 = _draws(jax_case["step1"][3])
    res = []
    for head_fn in (None, mlp_head):
        av.field.head_fn = head_fn
        st1 = _port_state(jax_case["states"][1], av)
        losses, _ = av.grads_and_losses(st1, b1, d1)
        res.append((losses, [p.grad.clone() for p in av.field.parameters()]))
    av.field.head_fn = None
    for k in res[0][0]:
        np.testing.assert_allclose(float(res[1][0][k]), float(res[0][0][k]),
                                   rtol=1e-6, err_msg=k)
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_train_golden_cpu():
    """The committed JAX golden (tools/make_torch_train_golden.py) replayed
    on the CPU, within the tolerances above; the update step leaves JAX's
    grid exactly."""
    for i, step in enumerate(golden_tool.replay_golden("cpu")):
        gaps = golden_tool.step_gaps(step, step)
        assert golden_tool.gaps_within_tolerance(gaps), (i, gaps)


def test_thirty_steps_learn():
    """30 ``AvatarModel.step`` calls from a fresh ``init`` (a grid update
    at steps 0 and 20) on the 48 px capsule scene: mse_loss falls below
    0.6x its first value, as tests/test_e2e_slice.py asks of JAX; losses
    stay finite and the grid shrinks from the full box to the body."""
    seq = make_capsule_sequence(4, 48, 48, bone_rings=2, device="cpu")
    ds = FrameDataset(seq["images"], seq["masks"], seq["K"], seq["c2w"],
                      seq["smpl_params"], "train",
                      sampler=PatchSampler(2, 16, ratio_mask=1.0,
                                           rng=np.random.default_rng(1)),
                      bg_rng=np.random.default_rng(2))
    av = golden_tool.port_avatar(k_cap=16, n_steps=64)
    gen = torch.Generator().manual_seed(0)
    state = av.init(seq["smpl_params"]["betas"], generator=gen)
    mse = []
    for i in range(30):
        state, losses = av.step(state, ds[i % len(ds)], gen)
        assert np.isfinite(float(losses["loss"]))
        mse.append(float(losses["mse_loss"]))
    assert state.step == 30 and state.opt_state.count == 30
    assert mse[-1] < 0.6 * mse[0], mse
    assert 0 < int(state.grid.occupancy.sum()) < 0.5 * C["grid_size"] ** 3
