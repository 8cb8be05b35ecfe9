"""The frame render's eval modes against the JAX package: the
shared-corner samplers and ``apply_shared`` (mirroring
tests/test_shared_corner.py), the packed-cache closures, the windowed and
probed marchers, the uncached eval field closures, and a 48 px frame in
each mode of ``AvatarModel`` (flat, windows, dense, the probed dense
march, uncached, shared-corner, tiled rows, no transmittance cut, the
alpha skip, the prepass dilation and margin) rendered by both packages
from the same params, canonical state and grid."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_torch import convert
from instantavatar_torch.body import toy_smpl_model
from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
from instantavatar_torch.deformers import SNARFDeformer
from instantavatar_torch.models import VoxelTriplaneField
from instantavatar_torch.ops import grid_sample as tgs
from instantavatar_torch.render import raymarcher as trm
from instantavatar_torch.train import AvatarModel, TrainState

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES, GRID, VR, PR, H = 32, 32, 16, 32, 48
AVATAR_KW = dict(n_steps=128, k_cap=8, grid_size=GRID, eval_n_steps=48,
                 cache_n_cand=1, eval_grid="smpl_shell", shell_margin=0.08)
SNARF_KW = dict(resolution=RES, cano_pose="a_pose", n_iters=6, cand_cap=2,
                n_init_active=4)
# each mode's knobs; the frame is held at MIN_DB against JAX's
MODES = {
    "flat": {},
    "windows": dict(eval_sampling="windows"),
    "windows_n4_no_term": dict(eval_sampling="windows", n_windows=4,
                               term_T=None),
    "dense": dict(eval_sampling="dense"),
    "dense_dilate2_margin3": dict(eval_sampling="dense", prepass_dilate=2,
                                  prepass_margin_steps=3.0),
    "cache_fused_probe": dict(eval_sampling="dense", cache_fused_probe=True),
    "uncached": dict(use_warp_cache=False),
    "shared_corner_eval": dict(shared_corner_eval=True),
    "flat_tile_rows": dict(flat_tile_rows=True),
    "term_T_none": dict(term_T=None),
    "alpha_skip": dict(alpha_skip=0.01),
    # the opaque field's strides carry baked alphas of 0.662-0.710, none
    # in 0.6676-0.6688 (port and JAX alike): 0.01 drops none, this drops
    # the lowest ~4%
    "alpha_skip_cut": dict(alpha_skip=0.6682),
}
MIN_DB = 40.0


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- samplers --------------------------------------------------------------

def test_shared_samplers_match_jax():
    """grid_sample_{2d,3d}_packed_shared (bf16 rows and fp32 rows) and
    grid_sample_3d on the inputs of tests/test_shared_corner.py's cases,
    variants inside and outside the reference cell (extrapolated values
    reach ~100): fp32 within 1e-5 relative of JAX; bf16 within one bf16
    step (2^-7 relative) of it."""
    from instantavatar_tpu.ops import grid_sample as jgs
    rng = np.random.RandomState(0)
    vox = rng.randn(4, 9, 9, 9).astype(np.float32)
    plane = rng.randn(6, 9, 9).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (5, 64, 3)).astype(np.float32)
    uv = rng.uniform(-0.05, 1.05, (3, 50, 2)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        p3 = tgs.pack_corners_3d(_t(vox)).to(dt)
        p2 = tgs.pack_corners_2d(_t(plane)).to(dt)
        j3 = jgs.pack_corners_3d(jnp.asarray(vox)).astype(jdt)
        j2 = jgs.pack_corners_2d(jnp.asarray(plane)).astype(jdt)
        got3 = tgs.grid_sample_3d_packed_shared(p3, (9, 9, 9), _t(coords[2]),
                                                _t(coords)).float().numpy()
        want3 = np.asarray(jgs.grid_sample_3d_packed_shared(
            j3, (9, 9, 9), coords[2], coords), np.float32)
        got2 = tgs.grid_sample_2d_packed_shared(p2, (9, 9), _t(uv[1]),
                                                _t(uv)).float().numpy()
        want2 = np.asarray(jgs.grid_sample_2d_packed_shared(
            j2, (9, 9), uv[1], uv), np.float32)
        for got, want in ((got3, want3), (got2, want2)):
            assert got.shape == want.shape
            if dt == torch.float32:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=2 ** -7)
    np.testing.assert_allclose(
        tgs.grid_sample_3d(_t(vox), _t(coords)).numpy(),
        np.asarray(jgs.grid_sample_3d(jnp.asarray(vox), coords)), atol=1e-5)


def test_apply_shared_matches_jax():
    """VoxelTriplaneField.apply_shared on converted params against JAX's
    (sub-cell variants, the production regime): the port's fused-head
    numerics against JAX's _mlp, within the 3e-2 head gap
    (tests/test_torch_head.py); the mlp head within 2e-2; and the shared
    encode equals the per-variant encode at the reference variant."""
    from instantavatar_tpu.models import VoxelTriplaneField as JaxField
    pnp = convert.seeded_field_params(VR, PR, seed=3, feat_std=0.3)
    jf = JaxField(voxel_res=VR, plane_res=PR)
    jparams = _jax_params(pnp)
    field = VoxelTriplaneField(voxel_res=VR, plane_res=PR, device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(pnp))
    rng = np.random.RandomState(3)
    x_ref = rng.uniform(-0.8, 0.8, (128, 3)).astype(np.float32)
    x = (x_ref[None] + rng.uniform(-1, 1, (4, 128, 3)).astype(np.float32)
         * (2.0 / PR / 8)).astype(np.float32)
    x[1] = x_ref
    center, scale = np.zeros(3, np.float32), np.float32(2.0)
    jrgb, jsig = jf.apply_shared(jparams, x_ref, x, center, scale)
    with torch.no_grad():
        for head, tol in (("fused", 3e-2), ("mlp", 2e-2)):
            rgb, sig = field.apply_shared(_t(x_ref), _t(x), _t(center),
                                          torch.tensor(2.0), head=head)
            assert rgb.shape == (4, 128, 3) and sig.shape == (4, 128)
            np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb),
                                       atol=tol)
            np.testing.assert_allclose(sig.numpy(), np.asarray(jsig),
                                       atol=tol)
        xn_r = (_t(x_ref) - _t(center)) / 2.0 + 0.5
        shared = field.encode_shared(xn_r, ((_t(x) - _t(center)) / 2.0
                                            + 0.5))
        torch.testing.assert_close(shared[1], field.encode(xn_r), atol=0,
                                   rtol=0)


def _jax_params(pnp):
    from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
    return VoxelTriplaneParams(**{
        k: (tuple(map(jnp.asarray, v)) if isinstance(v, list)
            else jnp.asarray(v)) for k, v in pnp.items()})


# -- packed-cache closures and marchers ------------------------------------

def _net_pair():
    """The same analytic field in both packages: (rgb, sigma) of points."""
    def net(x, xp):
        sigma = 30.0 * xp.sin(3.0 * x[..., 0]) * xp.cos(2.0 * x[..., 1]) \
            + 10.0 * x[..., 2]
        rgb = 0.5 + 0.5 * xp.tanh(x[..., [2, 0, 1]] * 1.7)
        return rgb, sigma
    return (lambda x: net(x, torch)), (lambda x: net(x, jnp))


def _cache_rows(G, K, seed):
    from instantavatar_tpu.deformers.packed_cache import ROW_FLOATS
    rng = np.random.RandomState(seed)
    rows = (rng.randn(G ** 3, K, ROW_FLOATS) * 0.1).astype(np.float32)
    rows[..., 12] = (rng.rand(G ** 3, K) > 0.3).astype(np.float32)
    rows[..., 3:12] = (np.eye(3).reshape(1, 1, 9) * 0.5
                       + rng.randn(G ** 3, K, 9) * 0.05)
    return rows.reshape(G ** 3, K * ROW_FLOATS)


@pytest.mark.parametrize("n_cand", [1, 2])
def test_packed_cache_fns_match_jax(n_cand):
    """make_packed_cache_fns' four closures against JAX's: probe (occupied
    and rows), occupancy, field_fn on given rows with and without
    centers, with pts_all (Q variants), with net_shared, and field_fn_pts;
    analytic fp32 field, within 1e-4. The port's fifth, rows_fn, gives
    the probe's rows exactly."""
    from instantavatar_tpu.deformers.packed_cache import \
        make_packed_cache_fns as jax_fns
    from instantavatar_torch.deformers.packed_cache import \
        make_packed_cache_fns as torch_fns
    G, K = 4, 2
    rows = _cache_rows(G, K, 4)
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    tnet, jnet = _net_pair()

    def shared(net, xp):
        return lambda xr, x: net(x)     # variants evaluated exactly
    tf = torch_fns(_t(rows), _t(aabb), G, tnet, n_cand,
                   net_shared=shared(tnet, torch))
    jf = jax_fns(jnp.asarray(rows), jnp.asarray(aabb), G, jnet, n_cand,
                 net_shared=shared(jnet, jnp))
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)
    pts_all = (pts[None] + rng.uniform(-1, 1, (3, 200, 3)) * 0.05) \
        .astype(np.float32)
    ctr = rng.uniform(-1, 1, (200, 3)).astype(np.float32)

    def close(a, b):
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x, np.float64),
                                       np.asarray(y, np.float64), atol=1e-4)
    close(tf[0](_t(pts)), jf[0](pts))
    torch.testing.assert_close(tf[4](_t(pts)), tf[0](_t(pts))[1], atol=0,
                               rtol=0)
    np.testing.assert_array_equal(tf[2](_t(pts)).numpy(),
                                  np.asarray(jf[2](pts)))
    close(tf[3](_t(pts)), jf[3](pts))
    r = jf[0](pts)[1]
    close(tf[1](_t(pts), _t(r)), jf[1](pts, r))
    close(tf[1](_t(pts), _t(r), _t(ctr)), jf[1](pts, r, ctr))
    close(tf[1](_t(pts), _t(r), _t(ctr), pts_all=_t(pts_all)),
          jf[1](pts, r, ctr, pts_all=pts_all))


def _ray_set(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    o[:, 2] -= 3.0
    d = rng.normal(0, 0.15, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_render_rays_windows_matches_jax():
    """render_rays_windows on preselected windows (some dropped, some
    pads at 1e9) through the packed closures of an analytic field:
    rgb/depth/alpha/weights within 1e-4, counters equal."""
    from instantavatar_tpu.deformers.packed_cache import \
        make_packed_cache_fns as jax_fns
    from instantavatar_tpu.render import raymarcher as jrm
    from instantavatar_torch.deformers.packed_cache import \
        make_packed_cache_fns as torch_fns
    G, K, N, W = 6, 1, 64, 10
    rows = _cache_rows(G, K, 6)
    aabb = np.array([[-1.0, -1.0, -4.0], [1.0, 1.0, -2.0]], np.float32)
    tnet, jnet = _net_pair()
    tf = torch_fns(_t(rows), _t(aabb), G, tnet)[3]
    jf = jax_fns(jnp.asarray(rows), jnp.asarray(aabb), G, jnet)[3]
    o, d = _ray_set(N, 7)
    rng = np.random.RandomState(8)
    z_w = np.sort(rng.uniform(0.5, 1.5, (N, W)), -1).astype(np.float32)
    keep = rng.rand(N, W) > 0.3
    z_w = np.where(keep, z_w, 1e9).astype(np.float32)
    step = np.full((N, 1), 0.05, np.float32)
    bg = rng.rand(N, 3).astype(np.float32)
    got = trm.render_rays_windows(tf, _t(o), _t(d), _t(z_w), _t(keep),
                                  _t(step), bg_color=_t(bg))
    want = jrm.render_rays_windows(jf, o, d, z_w, keep, step, bg_color=bg)
    for k in ("rgb", "depth", "alpha", "weights"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4)
    np.testing.assert_array_equal(got.counter.numpy(),
                                  np.asarray(want.counter))


def test_render_rays_probed_matches_jax():
    """render_rays_probed (one gather for occupancy and payload, the
    payload compacted with z) through the fused closures: within 1e-4,
    counters equal."""
    from instantavatar_tpu.deformers.packed_cache import \
        make_packed_cache_fns as jax_fns
    from instantavatar_tpu.render import raymarcher as jrm
    from instantavatar_torch.deformers.packed_cache import \
        make_packed_cache_fns as torch_fns
    G, K, N = 6, 2, 64
    rows = _cache_rows(G, K, 9)
    aabb = np.array([[-1.0, -1.0, -4.0], [1.0, 1.0, -2.0]], np.float32)
    tnet, jnet = _net_pair()
    tp, tfield = torch_fns(_t(rows), _t(aabb), G, tnet, 2)[:2]
    jp, jfield = jax_fns(jnp.asarray(rows), jnp.asarray(aabb), G, jnet, 2)[:2]
    o, d = _ray_set(N, 10)
    near = np.full(N, 0.2, np.float32)
    far = np.full(N, 2.5, np.float32)
    got = trm.render_rays_probed(
        tp, tfield, trm.Rays(_t(o), _t(d), _t(near), _t(far)),
        aabb=_t(aabb), n_steps=40, k_cap=6)
    from instantavatar_tpu.render.raymarcher import Rays as JRays
    want = jrm.render_rays_probed(jp, jfield, JRays(o, d, near, far),
                                  aabb=jnp.asarray(aabb), n_steps=40,
                                  k_cap=6)
    for k in ("rgb", "depth", "alpha", "weights"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4)
    np.testing.assert_array_equal(got.counter.numpy(),
                                  np.asarray(want.counter))
    assert int(got.counter.sum()) > 0


# -- the frame in every mode -------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    from instantavatar_tpu.body import toy_smpl_model as jax_toy
    from instantavatar_tpu.deformers import SNARFDeformer as JaxSNARF
    from instantavatar_tpu.models import VoxelTriplaneField as JaxField
    from instantavatar_tpu.train import AvatarModel as JaxAvatar
    pnp = convert.seeded_field_params(VR, PR, seed=3, sigma_bias=100.0)
    jbody = jax_toy(bone_rings=3)
    jfield, jdef = JaxField(voxel_res=VR, plane_res=PR), \
        JaxSNARF(jbody, **SNARF_KW)
    jav = JaxAvatar(jbody, jfield, jdef, **AVATAR_KW)
    jstate = jav.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    jstate = jstate._replace(params={**jstate.params,
                                     "field": _jax_params(pnp)})
    batch = _frame_batch()
    jgrid = jav.build_pose_grid(jstate, batch)

    body = toy_smpl_model(bone_rings=3, device="cpu")
    field = VoxelTriplaneField(voxel_res=VR, plane_res=PR, device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(pnp))
    state = TrainState(
        deformer_cano=convert.snarf_canonical_from_numpy(
            jax.tree.map(np.asarray, jstate.deformer_cano), device="cpu"),
        grid=None, center=_t(jstate.center), scale=_t(jstate.scale))
    grid = convert.grid_state_from_numpy(jax.tree.map(np.asarray, jgrid),
                                         device="cpu")
    return dict(jbody=jbody, jfield=jfield, jdef=jdef, jstate=jstate,
                jgrid=jgrid, body=body, field=field, state=state, grid=grid,
                batch=batch, frames={})


def _frame_batch():
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    pose[[46, 49]] = 0.2
    ro, rd = make_ray_grid(K, np.eye(4), H, H)
    n = H * H
    return {"ray_basis": make_ray_basis(K, np.eye(4)),
            "rays_o": ro.reshape(n, 3), "rays_d": rd.reshape(n, 3),
            "near": np.full(n, 4.0, np.float32),
            "far": np.full(n, 6.0, np.float32),
            "betas": np.zeros(10, np.float32), "body_pose": pose,
            "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
            "transl": np.array([0.0, 0.15, 5.0], np.float32)}


def _render_pair(scene, mode):
    from instantavatar_tpu.train import AvatarModel as JaxAvatar
    kw = {**AVATAR_KW, **MODES[mode]}
    jav = JaxAvatar(scene["jbody"], scene["jfield"], scene["jdef"], **kw)
    jout = jav.render_frame(scene["jstate"], scene["batch"],
                            grid=scene["jgrid"], image_shape=(H, H))
    av = AvatarModel(scene["body"], scene["field"],
                     SNARFDeformer(scene["body"], **SNARF_KW), **kw)
    out = av.render_frame(scene["state"], scene["batch"], grid=scene["grid"],
                          image_shape=(H, H))
    return out, jout


def _check_alpha(out, jout):
    """tests/test_torch_cli.py's alpha rule: within 2/255 except on at
    most one 3 x 3 block of pixels, there within 13/255; and past that, at
    most 2 pixels whose evaluated-sample count differs from JAX's by one
    (a dense-march sample on a grazing ray that fp32 rounding puts on the
    other side of a cell face; measured: 1 pixel, 0.22 in alpha, in the
    dilated dense mode)."""
    err = np.abs(out["alpha"].numpy() - np.asarray(jout["alpha"]))
    dcount = np.abs(out["counter"].numpy() - np.asarray(jout["counter"]))
    assert (err > 2 / 255).sum() <= 9, np.sort(err)[-12:]
    far = err > 13 / 255
    assert far.sum() <= 2 and (dcount[far] == 1).all(), \
        (np.nonzero(far), err[far], dcount[far])


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_matches_jax(scene, mode):
    """A 48 px frame of the opaque seeded avatar in ``mode``: rgb PSNR >=
    40 dB against JAX's frame in the same mode (its f16 payload and _mlp
    head against the port's fp32 frame and fused-head numerics), alpha by
    the CLI test's rule, finite, with body in it."""
    out, jout = _render_pair(scene, mode)
    rgb, alpha = out["rgb"].numpy(), out["alpha"].numpy()
    assert rgb.shape == (H * H, 3) and np.isfinite(rgb).all()
    assert 0.05 < alpha.mean() < 0.95
    db = _psnr(rgb, np.asarray(jout["rgb"]))
    assert db >= MIN_DB, (mode, db)
    _check_alpha(out, jout)
    scene["frames"][mode] = (rgb, np.asarray(jout["rgb"]))


def test_alpha_skip_drops_strides(scene):
    """alpha_skip at a threshold inside the baked alphas' range keeps
    fewer samples than the flat frame, and JAX drops the same strides:
    per-pixel sample counts equal, and the frame within MIN_DB of JAX's."""
    flat, _ = _render_pair(scene, "flat")
    out, jout = _render_pair(scene, "alpha_skip_cut")
    assert 0 < out["n_samples"] < 0.99 * flat["n_samples"], \
        (out["n_samples"], flat["n_samples"])
    assert float(out["counter"].sum()) < float(flat["counter"].sum())
    np.testing.assert_array_equal(out["counter"].numpy(),
                                  np.asarray(jout["counter"]))
    assert _psnr(out["rgb"].numpy(), np.asarray(jout["rgb"])) >= MIN_DB


def test_modes_agree_with_each_other(scene):
    """The modes against each other: between flat, windows, dense and
    uncached, the port's PSNR equals JAX's to 0.1 dB (the seeded field is
    high-frequency, so the modes' different samples differ by 17-25 dB in
    both packages), and the cached dense march stays within 30 dB of the
    uncached full search (JAX's bound, tests/test_e2e_slice.py:276;
    measured 38.3 dB in both)."""
    frames = scene["frames"]
    modes = ("flat", "windows", "dense", "uncached")
    for mode in modes:
        if mode not in frames:
            out, jout = _render_pair(scene, mode)
            frames[mode] = (out["rgb"].numpy(), np.asarray(jout["rgb"]))
    for i, a in enumerate(modes):
        for b in modes[i + 1:]:
            port = _psnr(frames[a][0], frames[b][0])
            ref = _psnr(frames[a][1], frames[b][1])
            assert abs(port - ref) <= 0.1, (a, b, port, ref)
    assert _psnr(frames["dense"][0], frames["uncached"][0]) > 30.0


def test_uncached_eval_field_matches_jax(scene):
    """The uncached eval closure (the full search per sample, no pose
    correction) against JAX's make_frame_field_fn(eval_mode=True) on the
    same frame and points, fp32 mlp head on both sides: rgb and sigma
    within 1e-3 where both are valid, validity equal on 99%."""
    from instantavatar_tpu.models import VoxelTriplaneField as JaxField
    jdef, jstate = scene["jdef"], scene["jstate"]
    b = scene["batch"]
    jframe = jdef.prepare_frame(jstate.deformer_cano, b["betas"][None],
                                b["body_pose"][None],
                                b["global_orient"][None],
                                b["transl"][None])
    jf = JaxField(voxel_res=VR, plane_res=PR, compute_dtype=jnp.float32)
    jfn = jdef.make_frame_field_fn(
        jstate.deformer_cano, jframe,
        lambda x: jf.apply(jstate.params["field"], x, jstate.center,
                           jstate.scale), eval_mode=True)
    av = AvatarModel(scene["body"], scene["field"],
                     SNARFDeformer(scene["body"], **SNARF_KW), **AVATAR_KW)
    tframe = av._prepare(scene["state"].deformer_cano, b)
    tf = scene["field"]
    tf.compute_dtype = torch.float32
    try:
        tfn = av.deformer.make_field_fn(
            scene["state"].deformer_cano, tframe,
            lambda x: tf.apply(x, scene["state"].center, scene["state"].scale,
                               head="mlp"), eval_mode=True)
        verts = np.asarray(jframe.verts_smpl).reshape(-1, 3)
        rng = np.random.RandomState(11)
        pts = (verts[rng.randint(0, len(verts), 400)]
               + rng.normal(0, 0.03, (400, 3))).astype(np.float32)
        with torch.no_grad():
            rgb, sig, ok = tfn(_t(pts))
    finally:
        tf.compute_dtype = torch.bfloat16
    jrgb, jsig, jok = jfn(pts)
    both = ok.numpy() & np.asarray(jok)
    assert (ok.numpy() == np.asarray(jok)).mean() >= 0.99
    assert both.sum() > 100
    np.testing.assert_allclose(sig.numpy()[both], np.asarray(jsig)[both],
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(rgb.numpy()[both], np.asarray(jrgb)[both],
                               atol=1e-3)


def test_basis_only_batch_needs_flat_mode(scene):
    """JAX's rule: a basis-only batch renders through the flat path only;
    an unknown eval_sampling is refused."""
    av = AvatarModel(scene["body"], scene["field"],
                     SNARFDeformer(scene["body"], **SNARF_KW),
                     **{**AVATAR_KW, "eval_sampling": "dense"})
    basis_only = {k: v for k, v in scene["batch"].items()
                  if k not in ("rays_o", "rays_d", "near", "far")}
    with pytest.raises(ValueError, match="flat path only"):
        av.render_frame(scene["state"], basis_only, grid=scene["grid"],
                        image_shape=(H, H))
    with pytest.raises(ValueError, match="eval_sampling"):
        AvatarModel(scene["body"], scene["field"], av.deformer,
                    eval_sampling="sparse")
