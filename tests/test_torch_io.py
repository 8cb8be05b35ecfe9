"""The port's file and data path against the JAX package and the libraries
it uses (cv2, imageio): the PNG codec, the downscale, the JET colormap and
the GIF writer; ``AvatarDataset``/``EdgeSampler`` batches against JAX's
Python path on the same seeds; the sequence writer against
``make_synthetic_sequence``; the metrics against JAX's; the SMPL loader
against JAX's."""
import pickle
import sys
import types
from pathlib import Path

import cv2
import imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.body import load_smpl_model as jax_load_smpl
from instantavatar_tpu.data import AvatarDataset as JaxDataset
from instantavatar_tpu.data import EdgeSampler as JaxEdgeSampler
from instantavatar_tpu.data import PatchSampler as JaxPatchSampler
from instantavatar_tpu.data import make_synthetic_sequence as jax_writer
from instantavatar_tpu.utils import metrics as jax_metrics
from instantavatar_torch.body import load_smpl_model
from instantavatar_torch.data import (AvatarDataset, EdgeSampler,
                                      PatchSampler, make_synthetic_sequence)
from instantavatar_torch.utils import metrics
from instantavatar_torch.utils.image_io import (gif_palette, jet, read_png,
                                                resize_linear, write_gif,
                                                write_png)


def _smooth_image(shape, seed):
    """Smooth gradients plus noise, so libpng picks every row filter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = np.sin(xx / 5.0) * 60 + np.cos(yy / 7.0) * 60 + 128
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 20
    return np.clip(base + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4)],
                         ids=["gray", "bgr", "bgra"])
def test_png_codec_matches_cv2(tmp_path, shape, level):
    """read_png returns what cv2.imread(IMREAD_UNCHANGED) returns, bit for
    bit, for cv2.imwrite's files at any compression (every filter type);
    cv2 reads write_png's files back bit for bit."""
    p = tmp_path / "a.png"
    for img in (_smooth_image(shape, level),
                np.random.default_rng(level).integers(0, 256, shape)
                .astype(np.uint8)):
        cv2.imwrite(str(p), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        out = read_png(p)
        assert out.shape == img.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, img)
        write_png(p, img)
        np.testing.assert_array_equal(cv2.imread(str(p),
                                                 cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("d", [2, 4])
def test_resize_linear_matches_cv2(d, channels):
    """resize_linear == cv2.resize(fx=fy=1/d) on float32 images within
    1e-6 (measured: bit for bit), at sizes a multiple of d and not."""
    rng = np.random.default_rng(d)
    for h, w in ((48, 48), (66, 50)):
        shape = (h, w) if channels == 1 else (h, w, channels)
        x = (rng.integers(0, 256, shape) / 255.0).astype(np.float32)
        ref = cv2.resize(x, dsize=None, fx=1 / d, fy=1 / d)
        out = resize_linear(x, d)
        assert out.shape == ref.shape and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_jet_within_one_step_of_cv2():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, ::-1].astype(int)
    ours = np.rint(jet(np.arange(256) / 255.0) * 255).astype(int)
    assert np.abs(ours - lut).max() <= 1


def test_gif_reads_back_in_imageio(tmp_path):
    """imageio reads the GIF back with every frame at its shape, each
    pixel within one palette step (the colour cube's spacing) of the
    frame written."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (30, 41, 3)).astype(np.uint8)
              for _ in range(5)]
    frames[0][:] = 255
    path = tmp_path / "a.gif"
    write_gif(path, frames, fps=30)
    back = imageio.mimread(path)
    assert len(back) == len(frames)
    step = np.array([51, 42.5, 51])             # 255 / (levels - 1)
    for got, want in zip(back, frames):
        assert got.shape[:2] == want.shape[:2]
        assert (np.abs(got[..., :3].astype(float) - want) <= step).all()
    assert set(map(tuple, back[0][..., :3].reshape(-1, 3))) == {(255,) * 3}
    assert gif_palette().shape == (256, 3)


@pytest.fixture(scope="module")
def jax_sequence(tmp_path_factory):
    return jax_writer(tmp_path_factory.mktemp("seq") / "seq", n_frames=4,
                      H=48, W=48, style="capsule", bone_rings=2)


def _same_batch(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_avatar_dataset_matches_jax(jax_sequence, split, downscale):
    """Every batch of AvatarDataset equals JAX's Python path (cv2 decode
    and resize) bit for bit, on the same sampler and background seeds."""
    kw = dict(start=0, end=3, skip=1 if split == "train" else 2,
              downscale=downscale, bg_rng=np.random.default_rng(7))
    s = 16 // downscale
    jds = JaxDataset(jax_sequence, split, native=False,
                     sampler=JaxPatchSampler(3, s, 0.8,
                                             rng=np.random.default_rng(3)),
                     **{**kw, "bg_rng": np.random.default_rng(7)})
    tds = AvatarDataset(jax_sequence, split,
                        sampler=PatchSampler(3, s, 0.8,
                                             rng=np.random.default_rng(3)),
                        **kw)
    assert len(tds) == len(jds) and tds.image_shape == jds.image_shape
    for i in list(range(len(tds))) * 2:     # the second pass decodes nothing
        _same_batch(tds[i], jds[i])


def test_edge_sampler_matches_jax(jax_sequence):
    """EdgeSampler batches equal JAX's (cv2 morphology), even and odd
    kernels."""
    for ks in (16, 5):
        jds = JaxDataset(jax_sequence, "train", end=3, native=False,
                         sampler=JaxEdgeSampler(
                             300, kernel_size=ks,
                             rng=np.random.default_rng(ks)),
                         bg_rng=np.random.default_rng(1))
        tds = AvatarDataset(jax_sequence, "train", end=3,
                            sampler=EdgeSampler(
                                300, kernel_size=ks,
                                rng=np.random.default_rng(ks)),
                            bg_rng=np.random.default_rng(1))
        for i in range(len(tds)):
            _same_batch(tds[i], jds[i])


@pytest.mark.parametrize("style,bone_rings", [("splat", 0), ("capsule", 2)])
def test_sequence_writer_matches_jax(tmp_path, style, bone_rings):
    """Cameras and poses exact, masks within 1e-5, images within one uint8
    step on <= 0.1% of pixels (measured: all identical)."""
    a = jax_writer(tmp_path / "jax", n_frames=3, H=48, W=56, style=style,
                   bone_rings=bone_rings)
    b = make_synthetic_sequence(tmp_path / "port", n_frames=3, H=48, W=56,
                                style=style, bone_rings=bone_rings,
                                device="cpu")
    for name in ("cameras.npz", "poses.npz"):
        x, y = np.load(a / name), np.load(b / name)
        assert x.files == y.files
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    for i in range(3):
        ma, mb = np.load(a / f"masks/{i:04d}.npy"), \
            np.load(b / f"masks/{i:04d}.npy")
        assert mb.dtype == ma.dtype and 0.02 < ma.mean() < 0.6
        np.testing.assert_allclose(mb, ma, rtol=0, atol=1e-5)
        ia = cv2.imread(str(a / f"images/{i:04d}.png")).astype(int)
        ib = read_png(b / f"images/{i:04d}.png").astype(int)
        gap = np.abs(ia - ib)
        assert gap.max() <= 1 or (gap > 1).mean() <= 1e-3
        assert (gap > 0).mean() <= 1e-3


def test_metrics_match_jax():
    """psnr, ssim (single image and batch) and Evaluator within 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.random((2, 33, 41, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1.1) \
        .astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for x, y, tx, ty in ((a, b, ta, tb), (a[0], b[0], ta[0], tb[0])):
        assert abs(float(metrics.psnr(tx, ty))
                   - float(jax_metrics.psnr(jnp.asarray(x),
                                            jnp.asarray(y)))) <= 1e-5
        assert abs(float(metrics.ssim(tx, ty))
                   - float(jax_metrics.ssim(jnp.asarray(x),
                                            jnp.asarray(y)))) <= 1e-5
    with pytest.warns(UserWarning, match="LPIPS"):
        ev = metrics.Evaluator()
    want = jax_metrics.Evaluator(lpips_fn=lambda p, t: jnp.zeros(1))(
        b[0], a[0])
    got = ev(b[0], a[0])
    assert got.keys() == {"psnr", "ssim"} and "trunk" in \
        ev.lpips_skip_reason
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5, k


def _smpl_arrays(V=30, J=24, seed=0):
    rng = np.random.default_rng(seed)
    parents = np.arange(-1, J - 1)
    return {"v_template": rng.standard_normal((V, 3)),
            "shapedirs": rng.standard_normal((V, 3, 12)),
            "posedirs": rng.standard_normal((V, 3, (J - 1) * 9)),
            "J_regressor": rng.random((J, V)),
            "weights": rng.random((V, J)),
            "kintree_table": np.stack([parents, np.arange(J)]),
            "f": rng.integers(0, V, (40, 3))}


def _same_model(a, b):
    for k in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)


def test_smpl_loader_matches_jax(tmp_path, monkeypatch):
    """The .npz release and the chumpy .pkl release (stub unpickler) load
    to the same model as JAX's loader."""
    raw = _smpl_arrays()
    np.savez(tmp_path / "SMPL_NEUTRAL.npz", **raw)
    _same_model(load_smpl_model(tmp_path, device="cpu"),
                jax_load_smpl(tmp_path))

    mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x
    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    mod.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", mod)
    pk = dict(raw, v_template=Ch(raw["v_template"]),
              shapedirs=Ch(raw["shapedirs"]))
    (tmp_path / "pkl").mkdir()
    with open(tmp_path / "pkl" / "SMPL_MALE.pkl", "wb") as f:
        pickle.dump(pk, f, protocol=2)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    model = load_smpl_model(tmp_path / "pkl", "male", device="cpu")
    _same_model(model, jax_load_smpl(tmp_path / "pkl", "male"))
    assert model.shapedirs.shape == (30, 3, 10)
    with pytest.raises(FileNotFoundError):
        load_smpl_model(tmp_path / "pkl", "female", device="cpu")
