"""Parity of the port's Fast-SNARF deformer against the JAX package at a
reduced voxel resolution (32). Later stages are fed the JAX stage's own
output (converted through numpy), so each test isolates one stage."""
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
    """KNN-30 inverse-distance weights + 30 Laplacian sweeps. KNN ties
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
