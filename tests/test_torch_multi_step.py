"""JAX's one-program training step in the port, on the CPU: K steps in
one ``train_multi_step`` call against K ``step`` calls and against JAX's
``train_multi_step``, the Trainer's K-step groups, the static cell budget
of the training bake, and a step path that reads nothing back to the
host (the property that lets the card capture it as a CUDA graph).

Tolerances: the port against itself exactly (the same kernels in the same
order); against JAX the last losses 1e-3 relative (``LOSS_RTOL``,
reg_density 5e-5 absolute: tools/make_torch_train_golden.py), the step
count and the grid's occupancy exactly, and the field parameters after 4
Adam steps 2e-6 absolute (measured 5.4e-7, in the hash table; the steps
move the parameters by up to 2.0e-2: Adam's lr of 5e-3 a step)."""
import json
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from instantavatar_tpu.train.optim import make_optimizer as jax_make_optimizer
from instantavatar_torch import convert
from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                      make_capsule_sequence)
from instantavatar_torch.losses.lpips import load_lpips
from instantavatar_torch.train import StepDraws, make_optimizer
from instantavatar_torch.train.harness import Trainer, iterate_grouped

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_ngp_golden as ngp_tool  # noqa: E402
import make_torch_smpl_golden as smpl_tool  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C = golden_tool.CONFIG
K = 4
# tests/test_e2e_slice.py:867's configuration
GRID4 = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4,
             per_level_scale=1.6)
MULTI_KW = dict(n_steps=32, k_cap=8, grid_size=8, noise_steps=0,
                grid_update_interval=2)
PARAM_ATOL = 2e-6


class NoHostRead(TorchDispatchMode):
    """Raises on every op that reads a tensor's value back to the host
    (``.item()``, ``bool()``, ``float()``, and the ops whose output shape
    depends on the data: ``nonzero``, boolean-mask indexing,
    ``bincount``, ``unique``, ``masked_select``) and on every tensor made
    from host data (``lift_fresh``: ``torch.tensor``, ``as_tensor`` of an
    array, indexing with a list), which on the card is a copy from
    pageable memory."""
    HOST = {"_local_scalar_dense", "nonzero", "bincount", "_unique",
            "_unique2", "unique_dim", "unique_consecutive", "masked_select",
            "repeat_interleave", "lift_fresh"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.HOST:
            raise AssertionError(f"host read: {func}")
        if name in ("index", "index_put", "index_put_") and any(
                t is not None and t.dtype == torch.bool for t in args[1]):
            raise AssertionError(f"boolean-mask index: {func}")
        return func(*args, **(kwargs or {}))


def test_host_read_guard_catches_syncs():
    """The guard itself: each kind of host read raises under it."""
    x = torch.ones(4)
    for fn in (lambda: x.sum().item(), lambda: bool(x.all()),
               lambda: torch.nonzero(x), lambda: x[x > 0],
               lambda: torch.bincount(x.long()), lambda: x[[0, 1]],
               lambda: torch.tensor([1.0]), lambda: torch.as_tensor(
                   np.ones(2))):
        with pytest.raises(AssertionError), NoHostRead():
            fn()


def _t(a):
    return torch.as_tensor(np.array(a))


def _batches(k=K):
    b = golden_tool.scene_batches()
    return [b[i % 2] for i in range(k)]


def _stack(batches):
    return {k: torch.as_tensor(np.stack([b[k] for b in batches]))
            for k in batches[0]}


def _field_state(av, state):
    """Every tensor a step moves: parameters, moments, counts, grid."""
    out = [p.detach().clone() for p in av.field.parameters()]
    opt = state.opt_state
    for group in ("field", "smpl"):
        mom = opt.moments(group)
        out += [m.clone() for m in (mom[0] + mom[1])] if mom else []
    out += [opt.count.clone(), opt.notfinite_count.clone()]
    out += [g.clone() for g in state.grid]
    out += [p.detach().clone() for p in state.smpl or ()]
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


# -- K steps in one call ------------------------------------------------------

def _port_ngp_smpl(**kw):
    return smpl_tool.port_smpl_avatar(
        grid=GRID4, optimizer=make_optimizer(5e-3), **{**MULTI_KW, **kw})


def test_multi_step_matches_sequential():
    """``train_multi_step`` (K = 4, grid updates at steps 0 and 2) leaves
    the state that 4 ``step`` calls with the same generator leave, bit
    for bit: parameters, moments, counts, the grid and the last losses
    (tests/test_e2e_slice.py:867's configuration: NGPField with 4
    levels, the SMPL deformer)."""
    av = _port_ngp_smpl()
    batches = _batches()
    ends = []
    for multi in (False, True):
        state = av.init(batches[0]["betas"],
                        generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(7)
        if multi:
            n = int(np.prod(batches[0]["rays_o"].shape[:-1]))
            state, losses = av.train_multi_step(
                state, _stack(batches), av.draw_steps(gen, n, 0, K))
        else:
            for b in batches:
                state, losses = av.step(state, b, gen)
        assert state.step == K and int(state.opt_state.count) == K
        ends.append((_field_state(av, state), losses))
    _assert_same(ends[0][0], ends[1][0])
    assert ends[0][1].keys() == ends[1][1].keys()
    for k in ends[0][1]:
        assert torch.equal(ends[0][1][k], ends[1][1][k]), k


def test_multi_step_matches_jax():
    """The port's ``train_multi_step`` against JAX's (one ``lax.scan``
    over K = 4 steps with the grid-update ``lax.cond``), from JAX's state
    0, each step given the draws JAX takes from its key: the last
    losses, the step count, the grid's occupancy exactly, the field
    parameters within ``PARAM_ATOL``."""
    jav = smpl_tool.jax_smpl_avatar(
        grid=GRID4, optimizer=jax_make_optimizer(5e-3), **MULTI_KW)
    batches = _batches()
    jst0 = ngp_tool.jax_ngp_state0(jav, batches[0]["betas"])
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    jst, jl = jav.train_multi_step(
        jst0, {k: jnp.stack([jnp.asarray(b[k]) for b in batches])
               for k in batches[0]}, keys)
    av = _port_ngp_smpl()
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst0), av.field, av, device="cpu")
    n = int(np.prod(batches[0]["rays_o"].shape[:-1]))
    c = {**C, **MULTI_KW}
    draws = []
    for i in range(K):
        d = golden_tool.jax_draws(keys[i], n, c, grid_update=i % 2 == 0)
        draws.append(StepDraws(_t(d["jitter"]), _t(d["noise"]),
                               None if i % 2 else _t(d["grid_jitter"])))
    state, losses = av.train_multi_step(state, _stack(batches), draws)
    assert state.step == int(jst.step) == K
    assert int(state.opt_state.count) == K
    np.testing.assert_array_equal(state.grid.occupancy.numpy(),
                                  np.asarray(jst.grid.occupancy))
    for k in ("mse_loss", "loss_alpha", "reg_alpha", "loss"):
        np.testing.assert_allclose(float(losses[k]), float(jl[k]),
                                   rtol=golden_tool.LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(losses["reg_density"]),
                               float(jl["reg_density"]),
                               atol=golden_tool.REG_DENSITY_ATOL)
    want = convert.field_params_from_numpy(
        jax.tree.map(np.asarray, jst.params["field"]))
    moved = 0.0
    for name, p in av.field.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, err_msg=name)
        moved = max(moved, float((want[name] - convert.field_params_from_numpy(
            jax.tree.map(np.asarray, jst0.params["field"]))[name]).abs()
            .max()))
    assert moved > 100 * PARAM_ATOL   # the steps did move the field


# -- the Trainer's K-step groups ----------------------------------------------

def test_iterate_grouped_tail():
    """JAX's tests/test_e2e_slice.py:910: groups of 2 over 5 indices are
    2, 2, 1 with a leading group axis, holding the getter's batches."""
    fixed = _batches(5)
    got = list(iterate_grouped(lambda i: fixed[i], range(5), 2))
    assert [g["rgb"].shape[0] for g in got] == [2, 2, 1]
    for j, g in enumerate(got):
        for i in range(g["rgb"].shape[0]):
            for k in fixed[0]:
                np.testing.assert_array_equal(g[k][i], fixed[2 * j + i][k])


def _capsule_trainset(n_frames):
    seq = make_capsule_sequence(n_frames, 48, 48, bone_rings=2,
                                device="cpu")
    return FrameDataset(seq["images"], seq["masks"], seq["K"], seq["c2w"],
                        seq["smpl_params"], "train",
                        sampler=PatchSampler(2, 16, ratio_mask=1.0,
                                             rng=np.random.default_rng(1)),
                        bg_rng=np.random.default_rng(2))


def test_trainer_multi_step_matches_single(tmp_path):
    """``Trainer(multi_step=4)`` over an epoch of 6 frames (groups of 4
    and 2) and a second epoch leaves the state of ``multi_step=1``, bit
    for bit, grid updates every 2 steps crossing the groups."""
    av = golden_tool.port_avatar(k_cap=16, n_steps=64,
                                 grid_update_interval=2)
    ends = []
    for multi in (4, 1):
        tr = Trainer(av, types.SimpleNamespace(trainset=_capsule_trainset(6)),
                     workdir=tmp_path / str(multi), max_epochs=2,
                     check_val_every_n_epoch=10, log_every_n_steps=5,
                     resume=False, multi_step=multi)
        state = tr.fit()
        assert state.step == 12 and tr.steps_run == 12
        ends.append((_field_state(av, state), tr.last_losses))
        logged = (tmp_path / str(multi) / "tensorboard" / "scalars.jsonl") \
            .read_text().splitlines()
        assert {json.loads(line)["step"] for line in logged} == (
            {6, 10} if multi == 4 else {5, 10})
    _assert_same(ends[0][0], ends[1][0])
    for k in ends[0][1]:
        assert torch.equal(ends[0][1][k], ends[1][1][k]), k


# -- the static cell budget -----------------------------------------------------

def _exact_cache(av, state, dstate, grid):
    """The exact-count training bake: ``torch.nonzero`` of the occupied
    cells, the first ``cell_budget`` baked, no padding."""
    G = av.grid_size
    cell_idx = torch.nonzero(grid.occupancy.reshape(-1))[:av.cell_budget, 0]
    ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                       cell_idx % G], dim=-1).float()
    span = grid.aabb[1] - grid.aabb[0]
    rows, _ = av.deformer.bake_packed_cache(
        state.deformer_cano, dstate, grid.aabb[0] + (ijk + 0.5) / G * span,
        net_sigma_fn=lambda x: av._net(state)(x)[1])
    cache = torch.zeros((G ** 3, rows.shape[-1]))
    cache[cell_idx] = rows
    return cache


@pytest.mark.parametrize("budget", [512, 32 ** 3])
def test_static_budget_bake_matches_exact_count(budget):
    """The static-budget bake (``cell_budget`` cells, the padding masked
    and dropped) gives the exact-count bake's cache and the same step
    (losses and gradients bit for bit), with the occupied cells above
    the budget (512 of ~2,700) and below it (all 32^3)."""
    av = golden_tool.port_avatar(cell_budget=budget)
    b = golden_tool.scene_batches()[0]
    av.field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(C["voxel_res"], C["plane_res"],
                                    C["param_seed"], feat_std=C["feat_std"],
                                    sigma_bias=C["sigma_bias"])))
    state = av.init(b["betas"])
    occ = torch.zeros(32 ** 3, dtype=torch.bool)
    occ[torch.randperm(32 ** 3, generator=torch.Generator().manual_seed(0))
        [:2700]] = True
    state = state._replace(grid=state.grid._replace(
        occupancy=occ.reshape(32, 32, 32)))
    assert (2700 > budget) == (budget == 512)
    dstate = av._prepare(state.deformer_cano, b)
    static = av._train_cache(state, dstate, state.grid)
    exact = _exact_cache(av, state, dstate, state.grid)
    assert torch.equal(static, exact)
    assert int((static[:, 12] > 0.5).sum()) > 0
    gen = torch.Generator().manual_seed(3)
    d = av.draw(gen, int(np.prod(b["rays_o"].shape[:-1])), False)
    outs = []
    for fn in (None, _exact_cache):
        if fn is not None:
            av._train_cache = lambda s, ds, g: fn(av, s, ds, g)
        losses, _ = av.grads_and_losses(state, b, d)
        outs.append((losses, [p.grad.clone()
                              for p in av.field.parameters()]))
    for k in outs[0][0]:
        assert torch.equal(outs[0][0][k], outs[1][0][k]), k
    for x, y in zip(outs[0][1], outs[1][1]):
        assert torch.equal(x, y)


# -- no host read -----------------------------------------------------------------

def test_adam_on_device_matches_optax_without_host_reads():
    """The device-side Adam through tests/test_torch_train.py's NaN plan
    (the epoch decay crossing an epoch, a skipped non-finite step, the
    give-up after ``skip_nonfinite`` in a row) with every ``step`` under
    the host-read guard: each update within 1e-6 of optax's, the gate,
    the count and the run of non-finite steps as optax keeps them."""
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
        with NoHostRead():
            applied = topt.step()
        assert bool(applied) == (kind == "ok" or i == len(plan) - 1), i
        assert int(topt.notfinite_count) == int(jstate.notfinite_count), i
        for p, b, k in zip(tparams, before, shapes):
            np.testing.assert_allclose(
                (p.detach() - b).numpy(), np.asarray(upd["field"][k]),
                atol=1e-6, err_msg=f"step {i} leaf {k}")
    assert int(topt.count) == 7


def _flagship():
    av = golden_tool.port_avatar(k_cap=16, n_steps=64)
    b = golden_tool.scene_batches()[0]
    return av, av.init(b["betas"], generator=torch.Generator()
                       .manual_seed(0)), b


def _ngp_smpl():
    av = _port_ngp_smpl(noise_steps=1000)
    b = golden_tool.scene_batches()[0]
    return av, av.init(b["betas"], generator=torch.Generator()
                       .manual_seed(0)), b


def _demo():
    """The demo's fit and train together: SMPL deformer, NGP,
    ``optimize_smpl``, ``smpl_init`` and ngp_loss with LPIPS and the
    depth term."""
    sp = make_capsule_sequence(3, 8, 8, bone_rings=2,
                               device="cpu")["smpl_params"]
    lw = {"w_rgb": 1.0, "w_alpha": 0.1, "w_reg": 0.1, "w_lpips": 0.01,
          "w_depth_reg": 0.01}
    with pytest.warns(UserWarning, match="RANDOM"):
        lpips = load_lpips("vgg", allow_random=True)
    av = smpl_tool.port_smpl_avatar(
        grid=GRID4, n_steps=32, k_cap=8, grid_size=16, optimize_smpl=True,
        smpl_init=True, loss_weights=lw, lpips_fn=lpips,
        optimizer=make_optimizer(5e-3, smpl_lr=1e-4))
    b = {**golden_tool.scene_batches()[0], "idx": np.int32(1)}
    return av, av.init(b["betas"], smpl_params=sp), b


@pytest.mark.parametrize("config", [_flagship, _ngp_smpl, _demo],
                         ids=["flagship", "ngp_smpl", "demo"])
def test_step_reads_nothing_back(config):
    """The captured step's body (``grads_and_losses(in_place=True)`` and
    the optimizer), given tensors, makes no host read, at steps 0 (the
    latch, the warm-up, noise) and 500: grid-update and plain steps.
    The in-place grid write leaves what the eager step returns."""
    av, state, b = config()
    b = {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
    gen = torch.Generator().manual_seed(1)
    n = int(np.prod(b["rays_o"].shape[:-1]))
    # the eager warm-up before a capture makes the cached constants
    av.grads_and_losses(state, b, av.draw(gen, n, True), True)
    for step in (0, 500):
        for update in (True, False):
            st = state._replace(step=step)
            d = av.draw(gen, n, update)
            _, want = av.grads_and_losses(st, b, d, update)
            want = [g.clone() for g in want]
            with NoHostRead():
                losses, grid = av.grads_and_losses(st, b, d, update,
                                                   in_place=True)
                st.opt_state.step()
            assert grid is st.grid
            for x, y in zip(grid, want):
                assert torch.equal(x, y)
            assert all(torch.isfinite(v) for v in losses.values())
