"""Parity of the port's body model, samplers, KNN, ray helpers and
render primitives against the JAX package, on numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.body import smpl_forward as jax_smpl_forward
from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.data import rays as jax_rays
from instantavatar_tpu.ops import grid_sample as jgs
from instantavatar_tpu.ops.knn import knn_points as jax_knn
from instantavatar_tpu.render.compositing import \
    composite_stream as jax_composite_stream
from instantavatar_tpu.render.raymarcher import \
    compact_samples as jax_compact
from instantavatar_torch.body import smpl_forward, toy_smpl_model
from instantavatar_torch.data import rays
from instantavatar_torch.ops import grid_sample as tgs
from instantavatar_torch.ops.knn import knn_points
from instantavatar_torch.render import compact_samples, composite_stream


def test_toy_model_and_smpl_forward_match_jax():
    """Toy construction is a numpy copy: exact. smpl_forward in fp32 on a
    random 2-frame pose: atol 1e-5 m on vertices, joints, A and T
    (summation order of the blend contractions only)."""
    jm = jax_toy(bone_rings=3)
    tm = toy_smpl_model(bone_rings=3, device="cpu")
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)))
    rng = np.random.default_rng(0)
    betas = (0.5 * rng.standard_normal((1, 10))).astype(np.float32)
    pose = (0.4 * rng.standard_normal((2, 69))).astype(np.float32)
    pose[1, :6] = 0.0  # exact-zero joints take the series branch
    orient = (0.5 * rng.standard_normal((2, 3))).astype(np.float32)
    transl = rng.standard_normal((2, 3)).astype(np.float32)
    jo = jax_smpl_forward(jm, jnp.asarray(betas), jnp.asarray(pose),
                          jnp.asarray(orient), jnp.asarray(transl))
    to = smpl_forward(tm, *map(torch.as_tensor, (betas, pose, orient,
                                                 transl)))
    for k in ("vertices", "joints", "A", "T", "v_shaped", "pose_offsets"):
        np.testing.assert_allclose(getattr(to, k).numpy(),
                                   np.asarray(getattr(jo, k)), atol=1e-5,
                                   err_msg=k)


def test_ray_helpers_are_exact_copies():
    K = np.array([[300.0, 0, 24], [0, 310.0, 20], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = np.array([[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]])
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    for a, b in zip(rays.make_ray_grid(K, c2w, 40, 48),
                    jax_rays.make_ray_grid(K, c2w, 40, 48)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rays.make_ray_basis(K, c2w),
                                  jax_rays.make_ray_basis(K, c2w))


@pytest.mark.parametrize("row_dtype", ["float32", "bfloat16"])
def test_packed_samplers_match_jax(row_dtype):
    """pack_corners_2d/3d exact; sampled values: f32 rows atol 1e-5, bf16
    rows (lerp in bf16, fp32 sum, one bf16 rounding) within one bf16 ulp
    of the feature scale (atol 1e-2 on N(0,1) features), and the fp32
    ``lerp_dtype`` override on bf16 rows atol 1e-5."""
    rng = np.random.default_rng(1)
    vox = rng.standard_normal((5, 6, 7, 8)).astype(np.float32)   # C,D,H,W
    plane = rng.standard_normal((4, 9, 10)).astype(np.float32)   # C,H,W
    jp3 = jgs.pack_corners_3d(jnp.asarray(vox))
    tp3 = tgs.pack_corners_3d(torch.as_tensor(vox))
    jp2 = jgs.pack_corners_2d(jnp.asarray(plane))
    tp2 = tgs.pack_corners_2d(torch.as_tensor(plane))
    np.testing.assert_array_equal(tp3.numpy(), np.asarray(jp3))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
    coords = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    jdt, tdt = getattr(jnp, row_dtype), getattr(torch, row_dtype)
    atol = 1e-5 if row_dtype == "float32" else 1e-2
    for lerp in (None, "float32"):
        j3 = jgs.grid_sample_3d_packed(
            jp3.astype(jdt), (6, 7, 8), jnp.asarray(coords),
            lerp_dtype=lerp and jnp.float32)
        t3 = tgs.grid_sample_3d_packed(
            tp3.to(tdt), (6, 7, 8), torch.as_tensor(coords),
            lerp_dtype=lerp and torch.float32)
        j2 = jgs.grid_sample_2d_packed(
            jp2.astype(jdt), (9, 10), jnp.asarray(uv),
            lerp_dtype=lerp and jnp.float32)
        t2 = tgs.grid_sample_2d_packed(
            tp2.to(tdt), (9, 10), torch.as_tensor(uv),
            lerp_dtype=lerp and torch.float32)
        tol = 1e-5 if lerp else atol
        assert t3.dtype == (torch.float32 if lerp else tdt)
        np.testing.assert_allclose(t3.float().numpy(),
                                   np.asarray(j3).astype(np.float32),
                                   atol=tol)
        np.testing.assert_allclose(t2.float().numpy(),
                                   np.asarray(j2).astype(np.float32),
                                   atol=tol)


def test_knn_points_matches_jax():
    """Distances atol 1e-5; indices may differ only between equidistant
    references (compare the distances those indices point at)."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    verts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    jd, ji = jax_knn(jnp.asarray(pts), jnp.asarray(verts), k=5, chunk=1024)
    td, ti = knn_points(torch.as_tensor(pts), torch.as_tensor(verts), k=5,
                        chunk=1024)
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    exact = ((pts[:, None] - verts[ti.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(exact, np.asarray(jd), atol=1e-5)


def test_compact_samples_matches_jax():
    valid = np.random.default_rng(3).random((200, 13)) < 0.3
    ji, jk = jax_compact(jnp.asarray(valid), 4)
    ti, tk = compact_samples(torch.as_tensor(valid), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_composite_stream_matches_jax_with_truncated_rays():
    """Ray-major stream with empty rays and rays whose offsets lie at or
    past M (truncated tail). fp32: atol 1e-4 on the accumulators: each is
    a difference of two stream-wide cumsum values (the depth column runs
    to ~200 here, fp32 ulp ~1.5e-5), summed in another order than XLA."""
    rng = np.random.default_rng(4)
    N = 60
    counts = rng.integers(0, 7, N).astype(np.int32)
    counts[[3, 17]] = 0
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    M = int(counts.sum()) - 9          # stream truncated 9 samples early
    ray_id = np.repeat(np.arange(N), counts)[:M].astype(np.int32)
    sigma = rng.uniform(-5, 60, M).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    z = (np.arange(M) * 0.01 + 4.0).astype(np.float32)
    dt = np.full(M, 0.02, np.float32)
    valid = rng.random(M) < 0.9
    args = (sigma, rgb, z, dt, valid, ray_id, offsets, counts)
    assert offsets.max() >= M
    ref = np.asarray(jax_composite_stream(*map(jnp.asarray, args)))
    out = composite_stream(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # float64 inputs run the same formula in float64
    out64 = composite_stream(*map(torch.as_tensor, (
        sigma.astype(np.float64),) + args[1:])).numpy()
    assert out64.dtype == np.float64
    np.testing.assert_allclose(out64, ref, atol=1e-4)
