"""The port's library modules that no pipeline path calls, against the
JAX package's on the CPU: mesh distance (tests/test_density_grid.py's
cases and seeded points: distances 1e-5, signs exact), marching
tetrahedra and the mesh utilities (tests/test_mesh_and_scripts.py's
sphere, OBJ and component cases: vertices and faces identical), the
coarse/fine volume renderer (tests/test_render.py's cases, JAX's uniforms
passed in: 1e-5), BODY25 keypoints (the toy body's core slots and a full
6890-vertex body: exact) and ``StepTimer`` (the same clock, the same
summary)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_torch.body import extra_joints as textra
from instantavatar_torch.ops import mesh_distance as tmd
from instantavatar_torch.render.raymarcher import Rays
from instantavatar_torch.render.volume_renderer import (VolumeRenderer,
                                                        importance_sampling)
from instantavatar_torch.utils import marching_cubes as tmc
from instantavatar_torch.utils import profiling as tprof

TETRA_V = np.asarray([[1., 1., 1.], [1., -1., -1.],
                      [-1., 1., -1.], [-1., -1., 1.]], np.float32)
TETRA_F = np.asarray([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- mesh distance ------------------------------------------------------------

def test_signed_distance_matches_jax():
    """tests/test_density_grid.py's tetrahedron (centroid inside, a far
    point, a face centroid on the surface) and 500 seeded points at least
    0.05 from the surface, in chunks of 64: distances within 1e-5 of JAX's;
    signs equal wherever the faces nearest to a point (in float64, within
    1e-6) agree on its side: the sign is the nearest face's normal, and
    where the nearest feature is an edge or vertex that faces share, their
    distances tie to the last bit and their normals can point either way;
    the all-pairs distances and closest points likewise."""
    from instantavatar_tpu.ops.mesh_distance import (
        point_triangle_distance as jax_ptd)
    from instantavatar_tpu.ops.mesh_distance import (
        signed_distance_to_mesh as jax_sd)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.5, 2.5, (2000, 3)).astype(np.float32)
    want = np.asarray(jax_sd(jnp.asarray(pts), jnp.asarray(TETRA_V),
                             TETRA_F))
    pts = pts[np.abs(want) > 0.05][:500]
    pts = np.concatenate([[[0, 0, 0], [3, 3, 3]],
                          TETRA_V[:3].mean(0, keepdims=True), pts]
                         ).astype(np.float32)
    want = np.asarray(jax_sd(jnp.asarray(pts), jnp.asarray(TETRA_V),
                             TETRA_F, chunk=64))
    got = tmd.signed_distance_to_mesh(_t(pts), _t(TETRA_V), TETRA_F,
                                      chunk=64).numpy()
    assert got[0] < 0 and abs(got[1] - 2 * np.sqrt(3)) < 1e-5
    assert abs(got[2]) < 1e-5
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-5)
    tri64 = _t(TETRA_V[TETRA_F]).double()
    d2, q = tmd.point_triangle_distance(_t(pts).double(), tri64)
    nrm = torch.linalg.cross(tri64[:, 1] - tri64[:, 0],
                             tri64[:, 2] - tri64[:, 0])
    side = torch.sign(((_t(pts).double()[:, None] - q) * nrm).sum(-1))
    tied = d2 <= d2.min(-1, keepdim=True).values + 1e-6
    clear = ((torch.where(tied, side, 0).abs().sum(-1)
              == torch.where(tied, side, 0).sum(-1).abs())).numpy()
    assert clear[3:].sum() > 250      # 308 of 500
    np.testing.assert_array_equal(np.sign(got[3:])[clear[3:]],
                                  np.sign(want[3:])[clear[3:]])
    tri = TETRA_V[TETRA_F]
    d2, q = tmd.point_triangle_distance(_t(pts[:64]), _t(tri))
    jd2, jq = jax_ptd(jnp.asarray(pts[:64]), jnp.asarray(tri))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)


# -- marching tetrahedra -----------------------------------------------------

def test_marching_tetrahedra_sphere_matches_jax():
    """The 48^3 sphere volume: the same vertices and faces as JAX's
    module, on the sphere of radius 0.6."""
    from instantavatar_tpu.utils.marching_cubes import marching_tetrahedra
    n = 48
    ax = np.linspace(-1, 1, n)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = 0.6 - np.sqrt(x * x + y * y + z * z)
    kw = dict(spacing=(2.0 / (n - 1),) * 3, origin=(-1.0, -1.0, -1.0))
    verts, faces = tmc.marching_tetrahedra(vol, 0.0, **kw)
    jverts, jfaces = marching_tetrahedra(vol, 0.0, **kw)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    r = np.linalg.norm(verts, axis=-1)
    assert len(faces) > 100 and abs(r.mean() - 0.6) < 0.02


def test_field_to_mesh_and_obj_match_jax(tmp_path):
    """``field_to_mesh`` of a torch density (a ball of radius 0.4 at
    (0.1, 0, 0) in the max norm, whose fp32 value is the same in both
    packages) against JAX's on the jnp density: the same mesh; the OBJ
    files identical."""
    from instantavatar_tpu.utils.marching_cubes import (field_to_mesh,
                                                        save_obj)

    def density(pts, xp):
        c = pts - xp.asarray([0.1, 0.0, 0.0], dtype=xp.float32)
        return 10.0 * (0.4 - xp.abs(c).max(-1) if xp is jnp
                       else 0.4 - c.abs().amax(-1))
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    verts, faces = tmc.field_to_mesh(lambda p: density(p, torch), aabb,
                                     resolution=32, chunk=5000,
                                     device="cpu")
    jverts, jfaces = field_to_mesh(lambda p: density(p, jnp), aabb,
                                   resolution=32, chunk=5000)
    assert len(verts) > 50
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    tmc.save_obj(tmp_path / "port.obj", verts, faces)
    save_obj(tmp_path / "jax.obj", jverts, jfaces)
    lines = (tmp_path / "port.obj").read_text().splitlines()
    assert lines == (tmp_path / "jax.obj").read_text().splitlines()
    assert sum(ln.startswith("f ") for ln in lines) == len(faces)


def test_largest_mesh_component_matches_jax():
    from instantavatar_tpu.utils.marching_cubes import largest_mesh_component
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [2, 0, 0], [3, 0, 0], [2, 1, 0],
                      [9, 9, 9], [10, 9, 9], [9, 10, 9]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2], [6, 7, 8]], np.int32)
    v, f = tmc.largest_mesh_component(verts, faces)
    jv, jf = largest_mesh_component(verts, faces)
    assert len(f) == 2 and len(v) == 4
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


# -- volume renderer ---------------------------------------------------------

def _sphere_field(xp, radius=0.5, color=(0.9, 0.1, 0.3)):
    """tests/test_render.py's opaque sphere, in either package."""
    def field_fn(x):
        if xp is jnp:
            inside = jnp.linalg.norm(x, axis=-1) < radius
            return (jnp.broadcast_to(jnp.asarray(color), x.shape),
                    jnp.where(inside, 500.0, -1e3),
                    jnp.ones(x.shape[:-1], bool))
        inside = torch.linalg.norm(x, dim=-1) < radius
        return (torch.tensor(color).expand(x.shape),
                torch.where(inside, 500.0, -1e3),
                torch.ones(x.shape[:-1], dtype=torch.bool))
    return field_fn


@pytest.mark.parametrize("keyed", [False, True])
def test_volume_renderer_matches_jax(keyed):
    """tests/test_render.py's sphere scene plus a miss ray: every output
    within 1e-5 of JAX's ``VolumeRenderer``, midpoint samples or JAX's
    draws (its key split into the coarse jitter and the importance
    uniforms) passed in; the depth at the sphere's surface."""
    from instantavatar_tpu.render.raymarcher import Rays as JRays
    from instantavatar_tpu.render.volume_renderer import \
        VolumeRenderer as JaxVR
    o = np.asarray([[0., 0., -3.], [0., 2., -3.]], np.float32)
    d = np.asarray([[0., 0., 1.], [0., 0., 1.]], np.float32)
    near, far = np.full(2, 0.1, np.float32), np.full(2, 6.0, np.float32)
    key = jax.random.PRNGKey(3) if keyed else None
    jout = JaxVR(32, 64)(_sphere_field(jnp), JRays(o, d, near, far),
                         key=key, bg_color=jnp.zeros(3))
    u = {}
    if keyed:
        k1, k2 = jax.random.split(key)
        u = {"u_coarse": _t(jax.random.uniform(k1, (2, 32))),
             "u_fine": _t(jax.random.uniform(k2, (2, 64)))}
    out = VolumeRenderer(32, 64)(_sphere_field(torch),
                                 Rays(_t(o), _t(d), _t(near), _t(far)),
                                 bg_color=torch.zeros(3), **u)
    assert set(out) == set(jout)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]),
                                   atol=1e-5, err_msg=k)
    assert abs(float(out["depth"][0]) - 2.5) < 0.05
    assert float(out["alpha"][0]) > 0.99 and float(out["alpha"][1]) < 1e-3


def test_importance_sampling_matches_jax():
    """tests/test_render.py's concentrated pdf with JAX's uniforms: the
    samples near the mass as in JAX's test, each within one coarse bin of
    JAX's (a sample in a bin of 1e-5 mass is the cdf's last bit, which
    the two packages' cumulative sums round apart, over that tiny width);
    a pdf with at least 1% in every bin, with JAX's uniforms and with the
    deterministic grid: within 1e-5 of JAX's."""
    from instantavatar_tpu.render.volume_renderer import \
        importance_sampling as jax_is
    z = np.linspace(0.0, 1.0, 32, dtype=np.float32)[None]
    w = np.zeros((1, 32), np.float32)
    w[0, 16] = 1.0
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_is(jnp.asarray(z), jnp.asarray(w), 64, key))
    u = _t(jax.random.uniform(key, (1, 64)))
    got = importance_sampling(_t(z), _t(w), 64, u).numpy()
    assert abs(got.mean() - z[0, 16]) < 0.05 and got.std() < 0.05
    np.testing.assert_allclose(got, want, atol=1 / 31)
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(0, 1, (4, 32)), -1).astype(np.float32)
    w = rng.uniform(0.3, 1.0, (4, 32)).astype(np.float32)
    u = jax.random.uniform(key, (4, 64))
    np.testing.assert_allclose(
        importance_sampling(_t(z), _t(w), 64, _t(u)).numpy(),
        np.asarray(jax_is(jnp.asarray(z), jnp.asarray(w), 64, key)),
        atol=1e-5)
    np.testing.assert_allclose(
        importance_sampling(_t(z), _t(w), 64).numpy(),
        np.asarray(jax_is(jnp.asarray(z), jnp.asarray(w), 64, None)),
        atol=1e-5)


# -- BODY25 keypoints --------------------------------------------------------

def test_body25_keypoints_match_jax():
    """The toy body's posed joints and vertices: the core skeleton slots,
    as JAX picks them; a full 6890-vertex body: all 25 slots, exactly."""
    from instantavatar_tpu.body import extra_joints as jextra
    from instantavatar_torch.body import smpl_forward, toy_smpl_model
    toy = toy_smpl_model(device="cpu")
    rng = np.random.default_rng(0)
    out = smpl_forward(toy, torch.zeros(1, 10),
                       _t(rng.normal(0, 0.2, (1, 69)).astype(np.float32)),
                       torch.zeros(1, 3), torch.zeros(1, 3))
    kp, slots = textra.body25_keypoints_or_core(out.joints, out.vertices)
    jkp, jslots = jextra.body25_keypoints_or_core(
        jnp.asarray(out.joints.numpy()), jnp.asarray(out.vertices.numpy()))
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    assert len(slots) < 25
    joints = rng.normal(size=(2, 24, 3)).astype(np.float32)
    verts = rng.normal(size=(2, 6890, 3)).astype(np.float32)
    kp, slots = textra.body25_keypoints_or_core(_t(joints), _t(verts))
    assert kp.shape == (2, 25, 3) and list(slots) == list(range(25))
    np.testing.assert_array_equal(
        kp.numpy(), np.asarray(jextra.body25_keypoints(joints, verts)))
    with pytest.raises(ValueError, match="6890"):
        textra.body25_keypoints(_t(joints), _t(verts[:, :100]))


# -- step timing --------------------------------------------------------------

def test_step_timer_summary_matches_jax(monkeypatch, tmp_path):
    """Both timers on the same clock (steps of 0.25, 0.5 and 0.75 s; the
    window keeps the last two): the same tick values and summary; a tick
    reads its tensor back. ``trace`` writes a Chrome trace."""
    from instantavatar_tpu.utils import profiling as jprof
    ticks = iter([10.0, 10.25, 10.75, 11.5] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timers = []
    for cls, s in ((tprof.StepTimer, torch.ones(3)),
                   (jprof.StepTimer, jnp.ones(3))):
        tm = cls(window=2)
        assert [tm.tick(s), tm.tick(), tm.tick(s)] == [0.25, 0.5, 0.75]
        timers.append(tm)
    assert timers[0].summary(rays_per_step=4096) == \
        timers[1].summary(rays_per_step=4096)
    assert timers[0].summary()["step_ms"] == 625.0
    monkeypatch.undo()
    with tprof.trace(tmp_path / "prof") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert "aten::mm" in {e.key for e in prof.key_averages()}
    assert "aten::mm" in (tmp_path / "prof" / "trace.json").read_text()
