"""The port's native data engine against the JAX package's, mirroring
tests/test_native_loader.py: both engines load the same sequence (JAX's
writer, so cv2's PNG filters; npy or 8-bit PNG masks), JAX's decoding it
with libpng and the port's from frames decoded by its ``read_png``, and
the port's batches must equal JAX's bit for bit at the same seeds. The
default data module takes the engine on train and the Python path on val
and test, as JAX's does. Without g++ (or, for the JAX side, libpng) the
tests skip."""
import glob

import numpy as np
import pytest

from instantavatar_torch.data import AvatarDataset, PatchSampler
from instantavatar_torch.utils.image_io import write_png


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    from instantavatar_tpu.data import make_synthetic_sequence
    root = tmp_path_factory.mktemp("torch_native")
    return make_synthetic_sequence(root / "seq", n_frames=3, H=48, W=48)


@pytest.fixture(scope="module")
def libs():
    """Both engines' libraries, or a skip naming what is missing."""
    from instantavatar_torch.data import native_loader
    try:
        native_loader.build_native_lib()
    except ImportError as e:
        pytest.skip(f"the port's native loader does not build here: {e}")
    from instantavatar_tpu.data import native_loader as jax_native
    try:
        jax_native.build_native_lib()
    except ImportError as e:
        pytest.skip(f"the JAX native loader does not build here: {e}")
    return native_loader, jax_native


def _paths(seq, ext="npy"):
    return (sorted(glob.glob(f"{seq}/images/*.png")),
            sorted(glob.glob(f"{seq}/masks/*.{ext}")))


@pytest.mark.parametrize("masks,downscale",
                         [("npy", 1), ("png", 1), ("npy", 2), ("png", 3)])
def test_engine_matches_jax(seq, libs, tmp_path, masks, downscale):
    """Patches (rgb, alpha, background, corners) at three seeds, ratio_mask
    1 and 0.5, dilate 0 and 2, and every full frame, from npy masks and
    from 8-bit PNG masks, at full size and box-filtered down: equal bit
    for bit."""
    native_loader, jax_native = libs
    imgs, msks = _paths(seq)
    if masks == "png":
        png_masks = []
        for i, m in enumerate(msks):
            path = tmp_path / f"{i:04d}.png"
            write_png(path, (np.load(m) * 255).astype(np.uint8))
            png_masks.append(str(path))
        msks = png_masks
    mine = native_loader.NativeSequenceCache(imgs, msks, downscale=downscale,
                                             n_threads=2)
    ref = jax_native.NativeSequenceCache(imgs, msks, downscale=downscale,
                                         n_threads=2)
    H = 48 // downscale
    assert (mine.height, mine.width) == (ref.height, ref.width) == (H, H)
    assert mine.decode_seconds > 0
    S = 16 // downscale
    for idx, seed, ratio, dil in ((0, 7, 1.0, 0), (1, 123, 0.5, 2),
                                  (2, 2 ** 40 + 5, 1.0, 2)):
        a = mine.sample_patches(idx, 3, S, ratio, dil, seed)
        b = ref.sample_patches(idx, 3, S, ratio, dil, seed)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for idx in range(3):
        for x, y in zip(mine.full_frame(idx), ref.full_frame(idx)):
            np.testing.assert_array_equal(x, y)
    mine.close()


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_native_batches_match_jax(seq, libs, split):
    """AvatarDataset(native=True) against JAX's at the same bg_rng seed:
    every key of four batches (the engine's seed and per-item draws come
    from bg_rng in JAX's order) equal bit for bit."""
    from instantavatar_tpu.data import AvatarDataset as JaxDataset
    from instantavatar_tpu.data import PatchSampler as JaxPatchSampler
    kw = dict(start=0, end=2, native=True)
    mine = AvatarDataset(seq, split, sampler=PatchSampler(2, 16, 0.9),
                         bg_rng=np.random.default_rng(3), **kw)
    ref = JaxDataset(seq, split, sampler=JaxPatchSampler(2, 16, 0.9),
                     bg_rng=np.random.default_rng(3), **kw)
    assert mine.native_active and ref._native is not None
    for idx in (0, 2, 1, 2):
        a, b = mine[idx], ref[idx]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_default_datamodule_takes_engine_on_train(seq, libs):
    """At conf defaults the train split runs on the engine and val/test
    on the Python path, in both packages; native=false turns it off."""
    from instantavatar_tpu.data import AvatarDataModule as JaxDM
    from instantavatar_torch.data import AvatarDataModule

    def opt(**extra):
        sampler = {"_target_": "instantavatar_tpu.data.PatchSampler",
                   "num_patch": 2, "patch_size": 16}
        return {"dataroot": str(seq), **extra,
                "train": {"start": 0, "end": 1, "sampler": sampler},
                "val": {"start": 2, "end": 2},
                "test": {"start": 2, "end": 2}}

    from instantavatar_tpu.config.engine import Config as JaxConfig
    from instantavatar_torch.config.engine import Config
    mine, ref = AvatarDataModule(Config(opt())), JaxDM(JaxConfig(opt()))
    assert mine.trainset.native_active and ref.trainset._native is not None
    for s in ("valset", "testset"):
        assert not getattr(mine, s).native_active
        assert getattr(ref, s)._native is None
    off = AvatarDataModule(Config(opt(native=False)))
    assert not off.trainset.native_active


def test_edge_sampler_keeps_python_path(seq, libs):
    """Like JAX, the engine serves PatchSampler and full-frame splits
    only: an EdgeSampler split asked for native stays on the Python path."""
    from instantavatar_torch.data import EdgeSampler
    ds = AvatarDataset(seq, "train", start=0, end=1, native=True,
                       sampler=EdgeSampler(64, kernel_size=4))
    assert not ds.native_active
    assert ds[0]["rgb"].shape == (64, 3)
