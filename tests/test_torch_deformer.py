"""Parity of the port's Fast-SNARF deformer against the JAX package at a
reduced voxel resolution (32). Later stages are fed the JAX stage's own
output (converted through numpy), so each test isolates one stage."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.deformers import SNARFDeformer as JaxSNARF
from instantavatar_torch import convert
from instantavatar_torch.body import toy_smpl_model
from instantavatar_torch.deformers import SNARFDeformer, SnarfFrame

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES = 32
KW = dict(resolution=RES, cano_pose="a_pose", n_iters=6, cand_cap=2,
          n_init_active=4)


def _pose():
    rng = np.random.default_rng(0)
    pose = (0.15 * rng.standard_normal(69)).astype(np.float32)
    return (np.zeros(10, np.float32), pose,
            np.array([0.1, 0.7, 0.0], np.float32),
            np.array([0.0, 0.15, 5.0], np.float32))


@pytest.fixture(scope="module")
def pair():
    jbody = jax_toy(bone_rings=3)
    jdef = JaxSNARF(jbody, **KW)
    jcano = jax.jit(jdef.build_canonical)(jnp.zeros((1, 10)))
    jframe = jax.jit(jdef.prepare)(jcano, *map(jnp.asarray, _pose()))
    tdef = SNARFDeformer(toy_smpl_model(bone_rings=3, device="cpu"), **KW)
    tcano = convert.snarf_canonical_from_numpy(
        jax.tree.map(np.asarray, jcano), device="cpu")
    tframe = SnarfFrame(**{k: torch.as_tensor(np.array(v)) for k, v in
                           jax.tree.map(np.asarray, jframe)._asdict()
                           .items()})
    return jdef, jcano, jframe, tdef, tcano, tframe


def test_build_canonical_matches_jax(pair):
    """KNN-30 inverse-distance weights + 30 Laplacian sweeps (and the bf16
    packed rows, exact). KNN ties
    may swap indices, so the baked weights are compared, not indices:
    atol 1e-3 on weights in [0, 1] (fp32 distance rounding moves the
    30th neighbour of a few cells; measured 2.4e-4); the mean gap must
    stay at rounding level (< 1e-6). Bounds and transforms atol 1e-5."""
    jdef, jcano, _, tdef, _, _ = pair
    tcano = tdef.build_canonical(torch.zeros(1, 10))
    lbs = tcano.lbs_voxel.numpy()
    jlbs = np.asarray(jcano.lbs_voxel)
    assert lbs.shape == (24, RES // 4, RES, RES)
    np.testing.assert_allclose(lbs, jlbs, atol=1e-3)
    assert np.abs(lbs - jlbs).mean() < 1e-6
    np.testing.assert_allclose(tcano.lbs_packed32.numpy(),
                               np.asarray(jcano.lbs_packed32), atol=1e-3)
    # the bf16 rows: the fp32 rows rounded, and carried across exactly
    assert torch.equal(tcano.lbs_packed, tcano.lbs_packed32.bfloat16())
    np.testing.assert_array_equal(
        pair[4].lbs_packed.float().numpy(),
        np.asarray(jcano.lbs_packed).astype(np.float32))
    for k in ("offset", "inv_scale", "tfs_inv_t", "vs_template",
              "joints_cano", "bbox"):
        np.testing.assert_allclose(getattr(tcano, k).numpy(),
                                   np.asarray(getattr(jcano, k)),
                                   atol=1e-5, err_msg=k)


def test_prepare_matches_jax(pair):
    """Per-frame bake on JAX's canonical state: the (M*8,24)@(24,12) fp32
    voxel_J bake and the warped cell positions, atol 1e-5."""
    jdef, _, jframe, tdef, tcano, _ = pair
    out = tdef.prepare(tcano, *map(torch.as_tensor, _pose()))
    for k in SnarfFrame._fields:
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(jframe, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tdef.bbox_deformed(out).numpy(),
                               np.asarray(jdef.bbox_deformed(jframe)),
                               atol=1e-5)


def _posed_queries(pair, n=600):
    """Posed SMPL-space points near the body surface (vertices + 1 cm)."""
    jframe = pair[2]
    v = np.asarray(jframe.verts_smpl)
    rng = np.random.default_rng(1)
    pick = rng.integers(0, v.shape[0], n)
    return (v[pick] + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)


def test_search_raw_matches_jax(pair):
    """Broyden search fed JAX's canonical and frame state. ``valid``
    (converged in bounds) must agree exactly; where valid, candidates
    atol 1e-4 m. J_inv is the quasi-Newton estimate at the step a lane
    froze: lanes whose residual crossed 1e-5 one step apart in the two
    fp32 runs differ by one rank-1 update, so J_inv is held at atol 1e-3
    on 99% of entries and atol 0.1 on all (measured 0.07% above 1e-3,
    max 0.046)."""
    jdef, jcano, jframe, tdef, tcano, tframe = pair
    xd = _posed_queries(pair)
    jx, jJ, jv, jres, jin = jax.jit(jdef._search_raw)(jcano, jframe,
                                                      jnp.asarray(xd))
    tx, tJ, tv, tres, tin = tdef._search_raw(tcano, tframe,
                                             torch.as_tensor(xd))
    jv = np.asarray(jv)
    assert jv.sum() > 0.5 * xd.shape[0]
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tx.numpy()[jv], np.asarray(jx)[jv], atol=1e-4)
    _assert_jinv_close(tJ.numpy()[jv], np.asarray(jJ)[jv])


def _assert_jinv_close(a, b):
    gap = np.abs(a - b)
    assert np.mean(gap > 1e-3) < 0.01, np.mean(gap > 1e-3)
    np.testing.assert_allclose(a, b, atol=0.1)


def test_bake_packed_cache_matches_jax(pair):
    """Warp-cache bake on posed cell centers (K=2 < I=4: compaction and
    the sigma sort both run), with the same analytic sigma function on
    both sides. The valid columns exact; candidates atol 1e-4 m; J_inv
    columns as in the search test; sigma_cell atol 1e-3."""
    jdef, jcano, jframe, tdef, tcano, tframe = pair
    cells = _posed_queries(pair, 400) + 0.02
    cells[:40] = np.random.default_rng(2).uniform(-1, 1, (40, 3))  # misses

    def sigma_fn(x):   # same arithmetic on jax and torch arrays
        return 50.0 + 40.0 * x[:, 0] - 30.0 * x[:, 1] * x[:, 2]

    jrows, jsig = jdef.bake_packed_cache(
        jcano, jframe, jnp.asarray(cells), net_sigma_fn=sigma_fn,
        return_sigma=True)
    trows, tsig = tdef.bake_packed_cache(
        tcano, tframe, torch.as_tensor(cells), net_sigma_fn=sigma_fn)
    jrows = np.asarray(jrows)
    assert trows.shape == jrows.shape == (400, 2 * 13)
    valid_cols = [12, 25]
    np.testing.assert_array_equal(trows.numpy()[:, valid_cols],
                                  jrows[:, valid_cols])
    assert jrows[:, 12].sum() > 100
    tr, jr = trows.numpy().reshape(400, 2, 13), jrows.reshape(400, 2, 13)
    np.testing.assert_allclose(tr[..., :3], jr[..., :3], atol=1e-4)
    _assert_jinv_close(tr[..., 3:12], jr[..., 3:12])
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), atol=1e-3)


# -- training side ------------------------------------------------------------

def test_search_query_weights_forward_skinning_match_jax(pair):
    """``search`` (dedup-filtered candidates): valid exact, candidates
    atol 1e-4 m, J_inv as in the raw search test. ``query_weights`` (bf16
    rows, fp32 lerp) atol 1e-6 and ``forward_skinning`` atol 1e-5 m at
    the same canonical points; forward skinning maps the valid
    candidates back onto their posed points (residual < 1e-3 m)."""
    jdef, jcano, jframe, tdef, tcano, tframe = pair
    xd = _posed_queries(pair)
    jxc, jv, jJ = jdef.search(jcano, jframe, jnp.asarray(xd))
    txc, tv, tJ = tdef.search(tcano, tframe, torch.as_tensor(xd))
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(txc.numpy(), np.asarray(jxc), atol=1e-4)
    _assert_jinv_close(tJ.numpy()[jv], np.asarray(jJ)[jv])
    xc = np.asarray(jxc)[jv]
    np.testing.assert_allclose(
        tdef.query_weights(tcano, torch.as_tensor(xc)).numpy(),
        np.asarray(jdef.query_weights(jcano, jnp.asarray(xc))), atol=1e-6)
    fwd = tdef.forward_skinning(tcano, tframe.tfs, torch.as_tensor(xc))
    np.testing.assert_allclose(
        fwd.numpy(), np.asarray(jdef.forward_skinning(
            jcano, jframe.tfs, jnp.asarray(xc))), atol=1e-5)
    resid = np.linalg.norm(fwd.numpy() - np.repeat(
        xd[:, None], jv.shape[1], 1)[jv], axis=-1)
    assert np.median(resid) < 1e-3


@pytest.mark.parametrize("version", [1, 2])
def test_grad_correct_pose_gradient_matches_jax(pair, version):
    """``_grad_correct`` on the search candidates: the value (v1: the
    candidates themselves; v2: re-skinned) atol 1e-4 m, and
    d(sum w * xc)/d(body_pose) through ``prepare``'s bake against
    ``jax.grad``, relative L2 gap 1e-4 (fp32 only on this path)."""
    _, jcano, _, tdef, tcano, _ = pair
    jdef = JaxSNARF(jax_toy(bone_rings=3), version=version, **KW)
    tdef = SNARFDeformer(tdef.body, version=version, **KW)
    betas, pose, orient, transl = _pose()
    xd = _posed_queries(pair, 300)
    wts = np.random.default_rng(7).normal(size=(300, KW["n_init_active"],
                                                3)).astype(np.float32)

    def jloss(body_pose):
        frame = jdef.prepare(jcano, jnp.asarray(betas), body_pose,
                             jnp.asarray(orient), jnp.asarray(transl))
        xc, valid, J_inv = jdef.search(jcano, frame, jnp.asarray(xd))
        out = jdef._grad_correct(jcano, frame, jnp.asarray(xd), xc, valid,
                                 J_inv)
        return jnp.sum(out * wts), out
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pose))
    bp = torch.as_tensor(pose).requires_grad_()
    frame = tdef.prepare(tcano, *map(torch.as_tensor, (betas,)), bp,
                         torch.as_tensor(orient), torch.as_tensor(transl))
    xc, valid, J_inv = tdef.search(tcano, frame, torch.as_tensor(xd))
    out = tdef._grad_correct(tcano, frame, torch.as_tensor(xd), xc, valid,
                             J_inv)
    (out * torch.as_tensor(wts)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    g = bp.grad.numpy()
    jg = np.asarray(jg)
    assert np.linalg.norm(jg) > 1e-3
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 1e-4


def test_make_field_fn_matches_jax(pair):
    """The full-search training closure (compaction to cand_cap, the pose
    correction, max-sigma select) with the same analytic field on both
    sides: rgb/sigma atol 1e-4, validity exact, and d(sum sigma +
    rgb)/d(field scale) relative 1e-4."""
    jdef, jcano, jframe, tdef, tcano, tframe = pair
    xd = _posed_queries(pair)

    def net(theta, xp):
        def apply(x):
            sigma = theta * (20.0 + 30.0 * x[:, 0] - 10.0 * x[:, 1] * x[:, 2])
            rgb = xp.stack([x[:, 0] ** 2, 0.5 + 0.2 * x[:, 1],
                            0.3 + 0.1 * x[:, 2]], -1)
            return rgb, sigma
        return apply

    def jf(theta):
        rgb, sigma, ok = jdef.make_field_fn(jcano, jframe, net(theta, jnp))(
            jnp.asarray(xd))
        return jnp.sum(jnp.where(ok, sigma, 0.0)) + jnp.sum(rgb), \
            (rgb, sigma, ok)
    (_, (jrgb, jsig, jok)), jg = jax.value_and_grad(jf, has_aux=True)(1.5)
    theta = torch.tensor(1.5, requires_grad=True)
    rgb, sigma, ok = tdef.make_field_fn(tcano, tframe, net(theta, torch))(
        torch.as_tensor(xd))
    (torch.where(ok, sigma, torch.zeros_like(sigma)).sum()
     + rgb.sum()).backward()
    jok = np.asarray(jok)
    assert jok.mean() > 0.5
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(sigma.detach().numpy()[jok],
                               np.asarray(jsig)[jok], atol=1e-4)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb),
                               atol=1e-4)
    np.testing.assert_allclose(float(theta.grad), float(jg), rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_sampler_gradients_match_jax(dtype):
    """Autograd through ``pack_corners_2d/3d`` and the packed samplers
    (the backward is a scatter-add onto the packed rows, then the corner
    sums onto the lattice) against ``jax.grad``, for the feature lattice
    and the sample coordinates. fp32 tables: relative L2 gap 1e-5. bf16
    tables (the field's rows; bf16 cotangents accumulate in another order
    than XLA's): 1e-2."""
    from instantavatar_tpu.ops import grid_sample as jgs
    from instantavatar_torch.ops import grid_sample as tgs
    rng = np.random.default_rng(11)
    vol = rng.normal(size=(4, 5, 9, 7)).astype(np.float32)
    plane = rng.normal(size=(6, 11, 13)).astype(np.float32)
    c3 = rng.uniform(-0.95, 0.95, (500, 3)).astype(np.float32)
    c2 = rng.uniform(0.02, 0.98, (500, 2)).astype(np.float32)
    w3 = rng.normal(size=(500, 4)).astype(np.float32)
    w2 = rng.normal(size=(500, 6)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(v, p, a, b):
        f3 = jgs.grid_sample_3d_packed(jgs.pack_corners_3d(v).astype(jdt),
                                       (5, 9, 7), a)
        f2 = jgs.grid_sample_2d_packed(jgs.pack_corners_2d(p).astype(jdt),
                                       (11, 13), b)
        return (jnp.sum(f3.astype(jnp.float32) * w3)
                + jnp.sum(f2.astype(jnp.float32) * w2))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(vol, plane, c3, c2)
    ts = [torch.as_tensor(a).requires_grad_() for a in (vol, plane, c3, c2)]
    f3 = tgs.grid_sample_3d_packed(tgs.pack_corners_3d(ts[0]).to(tdt),
                                   (5, 9, 7), ts[2])
    f2 = tgs.grid_sample_2d_packed(tgs.pack_corners_2d(ts[1]).to(tdt),
                                   (11, 13), ts[3])
    ((f3.float() * torch.as_tensor(w3)).sum()
     + (f2.float() * torch.as_tensor(w2)).sum()).backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, t, j in zip(("voxel", "plane", "coords3", "coords2"), ts,
                          jgrads):
        j = np.asarray(j)
        gap = np.linalg.norm(t.grad.numpy() - j) / np.linalg.norm(j)
        assert gap < tol, (name, gap)
