"""The port's data path against the JAX package on the CPU: the fp32
capsule tracer against JAX's jitted tracer, the capsule sequence against
``make_synthetic_sequence(style="capsule")`` read back from its PNGs, and
``PatchSampler`` plus the train/val batch assembly against
``AvatarDataset`` on the same numpy seeds, and ``MocapDataset`` (its
default ``EdgeSampler``, mirroring tests/test_samplers_edge_mocap.py) and
its batches against JAX's."""
import cv2
import numpy as np
import pytest

from instantavatar_tpu.body import smpl_forward as jax_smpl_forward
from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.data import AvatarDataset
from instantavatar_tpu.data import PatchSampler as JaxPatchSampler
from instantavatar_tpu.data import make_synthetic_sequence
from instantavatar_tpu.data.synthetic import \
    render_capsule_frame as jax_capsule
from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                      make_capsule_sequence,
                                      render_capsule_frame)

H = 48


def test_capsule_frame_matches_jax_48px():
    """One posed frame (bone lights from the full joint rotations) at
    48 px, 3x3 supersampling: coverage may differ by a subsample on
    grazing rays (1/9 at a few edge pixels; mean |diff| < 1e-3). Where
    both cover a pixel fully, the shaded colour is atol 1e-4 on 98% of the
    pixels; the rest sit where two capsules overlap at a joint and a
    subsample's nearest capsule (hence albedo and light) flips between
    the two fp32 tracers (measured 3 of 252 pixels, up to 0.03)."""
    body = jax_toy(bone_rings=2)
    pose = np.zeros((1, 69), np.float32)
    pose[0, 47], pose[0, 50] = 0.4, -0.3
    out = jax_smpl_forward(body, np.zeros((1, 10), np.float32), pose,
                           np.array([[0.0, 0.4, 0.0]], np.float32),
                           np.array([[0.0, 0.0, 3.0]], np.float32))
    joints = np.asarray(out.joints[0])
    rots = np.asarray(out.A[0, :, :3, :3])
    K = np.array([[H, 0, H / 2], [0, H, H / 2], [0, 0, 1]], np.float64)
    parents = np.asarray(body.parents)
    jimg, jmsk = jax_capsule(joints, parents, K, H, H, radii=0.07, ss=3,
                             seed=0, use_jax=True, bone_rots=rots)
    timg, tmsk = render_capsule_frame(joints, parents, K, H, H, radius=0.07,
                                      ss=3, seed=0, bone_rots=rots,
                                      device="cpu")
    timg, tmsk = timg.numpy(), tmsk.numpy()
    assert 0.03 < jmsk.mean() < 0.5
    dm = np.abs(tmsk - jmsk)
    assert dm.max() <= 1 / 9 + 1e-6 and dm.mean() < 1e-3
    full = (jmsk == 1.0) & (tmsk == 1.0)
    gap = np.abs(timg[full] - jimg[full]).max(-1)
    assert np.mean(gap > 1e-4) <= 0.02 and gap.max() < 0.1


@pytest.fixture(scope="module")
def seq_pair(tmp_path_factory):
    root = make_synthetic_sequence(tmp_path_factory.mktemp("caps"),
                                   n_frames=3, H=H, W=H, style="capsule",
                                   bone_rings=2)
    return root, make_capsule_sequence(3, H, H, bone_rings=2, device="cpu")


def test_capsule_sequence_matches_jax(seq_pair):
    """Poses, camera and masks as JAX writes them; the 8-bit images as
    JAX's PNGs read back (a rare 1/255 step where fp32 tracers round a
    value across a quantization boundary)."""
    root, seq = seq_pair
    poses = np.load(root / "poses.npz")
    for k, v in seq["smpl_params"].items():
        np.testing.assert_array_equal(v, poses[k], err_msg=k)
    cam = np.load(root / "cameras.npz")
    np.testing.assert_array_equal(seq["K"], cam["intrinsic"])
    np.testing.assert_array_equal(seq["c2w"], np.linalg.inv(cam["extrinsic"]))
    for i in range(3):
        msk = np.load(root / f"masks/{i:04d}.npy")
        assert np.abs(seq["masks"][i] - msk).max() <= 1 / 9 + 1e-6
        assert np.abs(seq["masks"][i] - msk).mean() < 1e-3
        img = cv2.imread(str(root / f"images/{i:04d}.png"))[..., :3] / 255.0
        both = (msk == 1.0) & (seq["masks"][i] == 1.0)
        d = np.abs(seq["images"][i] - img)[both]
        assert d.max() <= 1 / 255 + 1e-6 and d.mean() < 1e-3


@pytest.mark.parametrize("dilate", [0, 3])
def test_patch_sampler_matches_jax(dilate):
    """Same numpy seed, same patches (mask-centred draws, the uniform
    fallback and the 3x3 dilation)."""
    rng = np.random.default_rng(0)
    mask = np.zeros((64, 64), np.float32)
    mask[20:40, 25:35] = 1.0
    img = rng.random((64, 64, 3), dtype=np.float32)
    js = JaxPatchSampler(4, 16, 0.7, dilate, rng=np.random.default_rng(5))
    ts = PatchSampler(4, 16, 0.7, dilate, rng=np.random.default_rng(5))
    for _ in range(6):
        for a, b in zip(ts.sample(mask, img), js.sample(mask, img)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "val"])
def test_batch_assembly_matches_jax(seq_pair, split):
    """``FrameDataset`` over the read-back frames against
    ``AvatarDataset`` on the PNG directory, same sampler and background
    seeds: every batch array exact (random background, the blend, patch
    cut, rays, ray basis, near/far)."""
    root = seq_pair[0]
    sampler = dict(num_patch=2, patch_size=16, ratio_mask=0.9)
    jds = AvatarDataset(root, split, start=0, end=2,
                        sampler=JaxPatchSampler(
                            **sampler, rng=np.random.default_rng(1)),
                        bg_rng=np.random.default_rng(2))
    imgs = np.stack([cv2.imread(str(root / f"images/{i:04d}.png"))[..., :3]
                     / 255.0 for i in range(3)]).astype(np.float32)
    msks = np.stack([np.load(root / f"masks/{i:04d}.npy") for i in range(3)])
    cam = np.load(root / "cameras.npz")
    tds = FrameDataset(imgs, msks, cam["intrinsic"],
                       np.linalg.inv(cam["extrinsic"]),
                       {k: v.astype(np.float32) for k, v in
                        np.load(root / "poses.npz").items()},
                       split, sampler=PatchSampler(
                           **sampler, rng=np.random.default_rng(1)),
                       bg_rng=np.random.default_rng(2))
    assert len(tds) == len(jds) == 3
    for i in (0, 2, 1):
        a, b = tds[i], jds[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
    shape = (2, 16, 16) if split == "train" else (H * H,)
    assert a["alpha"].shape == shape and a["rgb"].shape == shape + (3,)


def test_mocap_dataset_default_edge_sampler(seq_pair):
    """MocapDataset's train split samples with EdgeSampler(num_samples,
    0.6, 0.3, 32) by default: flat (256,) ray batches; the val split has
    no sampler and full frames."""
    from instantavatar_torch.data import EdgeSampler, MocapDataset
    root = seq_pair[0]
    ds = MocapDataset(root, "train", start=0, end=1, num_samples=256)
    assert isinstance(ds.sampler, EdgeSampler)
    assert (ds.sampler.num_mask, ds.sampler.num_edge, ds.sampler.num_rand,
            ds.sampler.kernel_size) == (153, 76, 27, 32)
    b = ds[0]
    assert b["rgb"].shape == (256, 3) and b["rays_o"].shape == (256, 3)
    assert b["alpha"].shape == (256,) and b["body_pose"].shape == (69,)
    dv = MocapDataset(root, "val", start=0, end=0)
    assert dv.sampler is None
    assert dv[0]["rgb"].shape == (H * H, 3)


@pytest.mark.parametrize("split", ["train", "val"])
def test_mocap_batches_match_jax(seq_pair, split):
    """MocapDataset against JAX's on the PNG directory, the edge sampler
    and the background on the same numpy seeds: every batch array exact."""
    from instantavatar_tpu.data.datasets import MocapDataset as JaxMocap
    from instantavatar_torch.data import MocapDataset
    root = seq_pair[0]
    kw = dict(start=0, end=2, num_samples=200)
    tds = MocapDataset(root, split, bg_rng=np.random.default_rng(2), **kw)
    jds = JaxMocap(root, split, bg_rng=np.random.default_rng(2), **kw)
    if split == "train":
        tds.sampler.rng = np.random.default_rng(1)
        jds.sampler.rng = np.random.default_rng(1)
    for i in (1, 0, 2):
        a, b = tds[i], jds[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
