"""The port's occupancy-grid sweep against the JAX package on the CPU: the
filters (max pool, largest component), ``update_grid`` with its gradient,
``occupancy_regularizer``, ``initialize_grid`` and ``occupancy_lookup``
on the same jitter, then ``AvatarModel.build_test_grid`` on the toy body
with the ``_mlp`` head swapped into the port (``head_fn``) and JAX's
``PRNGKey(0)`` draws passed in, and the density eval grid of
``render_frame``. Occupancy is held exactly; densities at fp32 rounding."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.render import density_grid as jdg
from instantavatar_torch import convert
from instantavatar_torch.data.rays import make_ray_basis
from instantavatar_torch.models import mlp_head
from instantavatar_torch.render import density_grid as tdg

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

AABB = np.array([[-1.0, -0.9, -1.1], [1.0, 1.2, 0.9]], np.float32)
G = 16


def _t(a):
    return torch.as_tensor(np.array(a))


def _blobs(theta, xp):
    """Two soft blobs of different size (same arithmetic on jax and torch
    arrays), scaled by the parameter ``theta``."""
    def ball(x, c, r):
        d2 = ((x[:, 0] - c[0]) ** 2 + (x[:, 1] - c[1]) ** 2
              + (x[:, 2] - c[2]) ** 2)
        return xp.clip(1.0 - d2 / r ** 2, 0.0, None)
    return lambda x: theta * (300.0 * ball(x, (-0.3, 0.1, 0.0), 0.45)
                              + 150.0 * ball(x, (0.6, -0.5, 0.4), 0.2)
                              - 2.0)


def test_max_pool_and_largest_component_match_jax():
    """Random blobs at G=16: max pool exact; the largest 26-connected
    component exact (several components, including diagonal contacts)."""
    rng = np.random.default_rng(0)
    x = rng.random((G, G, G), dtype=np.float32)
    np.testing.assert_array_equal(tdg.max_pool3d(_t(x)).numpy(),
                                  np.asarray(jdg.max_pool3d(jnp.asarray(x))))
    for seed in range(3):
        occ = np.random.default_rng(seed).random((G, G, G)) < 0.3
        want = np.asarray(jdg.largest_component(jnp.asarray(occ)))
        got = tdg.largest_component(_t(occ)).numpy()
        assert 0 < want.sum() < occ.sum()
        np.testing.assert_array_equal(got, want)
    empty = tdg.largest_component(torch.zeros((4, 4, 4), dtype=torch.bool))
    assert not empty.any()


@pytest.mark.parametrize("step", [100, 700])
def test_update_grid_and_regularizer_match_jax(step):
    """Two chained updates from an empty grid on JAX's jitter draws: the
    EMA cache (rtol 1e-5), occupancy (exact), the normalized density
    (atol 1e-6); then the occupancy regularizer (warmup on and off) and
    its gradient in the density function's parameter (rtol 1e-4)."""
    keys = jax.random.split(jax.random.PRNGKey(step), 2)
    jit = [np.asarray(jax.random.uniform(k, (G, G, G, 3))) for k in keys]
    jstate = jdg.make_grid_state(jnp.asarray(AABB), G)
    tstate = tdg.make_grid_state(AABB, G, device="cpu")
    for i, (k, j) in enumerate(zip(keys, jit)):
        theta = 1.0 + 0.5 * i
        jstate, jdn, jold = jdg.update_grid(jstate, _blobs(theta, jnp), k)
        tstate, tdn, told = tdg.update_grid(tstate, _blobs(theta, torch),
                                            _t(j))
        np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
        np.testing.assert_array_equal(tstate.occupancy.numpy(),
                                      np.asarray(jstate.occupancy))
        np.testing.assert_allclose(tstate.density_cached.numpy(),
                                   np.asarray(jstate.density_cached),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tdn.numpy(), np.asarray(jdn), atol=1e-6)
    occ = np.asarray(jstate.occupancy)
    assert 0.01 < occ.mean() < 0.5

    def jreg(theta):
        _, dn, _ = jdg.update_grid(jstate, _blobs(theta, jnp), keys[1])
        return jdg.occupancy_regularizer(dn, jstate.occupancy,
                                         jnp.int32(step), 20)
    jr, jg = jax.value_and_grad(jreg)(1.3)
    theta = torch.tensor(1.3, requires_grad=True)
    _, tdn, _ = tdg.update_grid(tstate, _blobs(theta, torch), _t(jit[1]))
    tr = tdg.occupancy_regularizer(tdn, tstate.occupancy, step, 20)
    tr.backward()
    np.testing.assert_allclose(tr.item(), float(jr), rtol=1e-5)
    np.testing.assert_allclose(float(theta.grad), float(jg), rtol=1e-4)


def test_initialize_grid_and_lookup_match_jax():
    """Five jittered passes (JAX's ``split(key, 5)`` draws): max density
    (atol 1e-4: fp32 rounding of densities up to 300), occupancy exact, and the cell lookup of points inside,
    outside and on the box faces exact."""
    key = jax.random.PRNGKey(0)
    jit = np.stack([np.asarray(jax.random.uniform(k, (G, G, G, 3)))
                    for k in jax.random.split(key, 5)])
    jgrid = jdg.initialize_grid(jnp.asarray(AABB), _blobs(1.0, jnp), key, G)
    tgrid = tdg.initialize_grid(_t(AABB), _blobs(1.0, torch), _t(jit), G)
    np.testing.assert_allclose(tgrid.density_cached.numpy(),
                               np.asarray(jgrid.density_cached), atol=1e-4)
    np.testing.assert_array_equal(tgrid.occupancy.numpy(),
                                  np.asarray(jgrid.occupancy))
    pts = np.random.default_rng(4).uniform(-1.3, 1.3, (2000, 3))
    pts[:4] = [AABB[0], AABB[1], (0, 0, 0.9), (0, 1.2, 0)]
    pts = pts.astype(np.float32)
    np.testing.assert_array_equal(
        tdg.occupancy_lookup(tgrid, _t(pts)).numpy(),
        np.asarray(jdg.occupancy_lookup(jgrid, jnp.asarray(pts))))


# -- the model's test grid ----------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import make_torch_train_golden as golden_tool
    c = dict(golden_tool.CONFIG)
    jav = golden_tool.jax_avatar(c)
    jst = golden_tool.jax_state0(jav, np.zeros(10, np.float32), c)
    av = golden_tool.port_avatar(c)
    st = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                        av.field, av, device="cpu")
    H = 24
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "betas": np.zeros(10, np.float32), "body_pose": pose,
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    return jav, jst, av, st, batch, H


def test_build_test_grid_matches_jax(scene):
    """``build_test_grid`` (deformed-body AABB, 5 jittered full-search
    density passes, threshold, largest component) with the port's head set
    to ``_mlp`` numerics and JAX's ``PRNGKey(0)`` draws: AABB atol 1e-5,
    occupancy exact, max density rtol 2e-3 (a hidden unit's bf16 rounding
    can flip between the two matmul orders: measured one cell of 32,768 at
    1e-3 relative)."""
    jav, jst, av, st, batch, _ = scene
    jgrid = jav.build_test_grid(jst, batch)
    G_ = av.grid_size
    jit = np.stack([np.asarray(jax.random.uniform(k, (G_, G_, G_, 3)))
                    for k in jax.random.split(jax.random.PRNGKey(0), 5)])
    av.field.head_fn = mlp_head
    try:
        grid = av.build_test_grid(st, batch, jitter=_t(jit))
    finally:
        av.field.head_fn = None
    occ = np.asarray(jgrid.occupancy)
    assert 0.01 < occ.mean() < 0.5
    np.testing.assert_allclose(grid.aabb.numpy(), np.asarray(jgrid.aabb),
                               atol=1e-5)
    np.testing.assert_array_equal(grid.occupancy.numpy(), occ)
    np.testing.assert_allclose(grid.density_cached.numpy(),
                               np.asarray(jgrid.density_cached), rtol=2e-3,
                               atol=1e-6)


def test_render_frame_builds_density_grid(scene):
    """``render_frame(grid=None)`` with the default ``eval_grid="density"``
    builds the test grid (default draws) and renders the flat stream; it
    equals rendering with that grid passed in, and the body shows."""
    _, _, av, st, batch, H = scene
    assert av.eval_grid == "density"
    out = av.render_frame(st, batch, image_shape=(H, H))
    grid = av.build_test_grid(st, batch)
    ref = av.render_frame(st, batch, grid=grid, image_shape=(H, H))
    assert out["n_occ"] == int(grid.occupancy.sum()) > 0
    np.testing.assert_array_equal(out["rgb"].numpy(), ref["rgb"].numpy())
    assert 0.02 < float(out["alpha"].mean()) < 0.9
