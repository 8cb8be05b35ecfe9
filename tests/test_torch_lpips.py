"""The port's LPIPS against the JAX package's on the CPU: JAX's random
trunk (``_random_trunk(net, PRNGKey(0))``) and the shipped heads carried
through numpy into both. Distances 1e-4 relative, the gradient with
respect to the prediction 1e-3 L2-relative, the heads bit for bit; a
trunk file in the torchvision key layout read by both ``load_lpips``;
``ngp_loss``'s LPIPS term and the Evaluator's LPIPS column.

AlexNet is held at 32 and 64 px: at 16 px its second 3x3/2 pool meets a
1 x 1 map and leaves nothing (an empty tap in JAX, an error in PyTorch);
VGG at 16 and 32 px (the fitting conf's patches are 32 px)."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.losses import lpips as jax_lpips
from instantavatar_tpu.losses.nerf_loss import ngp_loss as jax_ngp_loss
from instantavatar_tpu.utils import metrics as jax_metrics
from instantavatar_torch import convert
from instantavatar_torch.losses import lpips, ngp_loss
from instantavatar_torch.utils import metrics

# torchvision ``features`` indices of each conv
FEATURE_IDX = {"vgg": (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
               "alex": (0, 3, 6, 8, 10)}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=["vgg", "alex"])
def pair(request):
    """(net, JAX LPIPS, the port's LPIPS) on JAX's random trunk."""
    net = request.param
    params = jax_lpips.LPIPSParams(
        convs=jax_lpips._random_trunk(net, jax.random.PRNGKey(0)),
        heads=jax_lpips._shipped_heads(net))
    jl = jax_lpips.LPIPS(net, params)
    tl = convert.lpips_from_numpy(jax.tree.map(np.asarray, params), net)
    return net, jl, tl


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, size, size, 3), dtype=np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1) \
        .astype(np.float32)
    return a, b


def _sizes(net):
    return (16, 32) if net == "vgg" else (32, 64)


def test_distances_match_jax(pair):
    net, jl, tl = pair
    for size in _sizes(net):
        a, b = _images(2, size, seed=size)
        want = np.asarray(jax.jit(jl.__call__)(jnp.asarray(a),
                                               jnp.asarray(b)))
        got = tl(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        assert got.shape == (2,) and np.all(want > 0)
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=str(size))


def test_gradient_matches_jax(pair):
    """d sum(lpips) / d pred at 1e-3 L2-relative; the target takes none."""
    net, jl, tl = pair
    a, b = _images(2, _sizes(net)[-1], seed=7)
    want = np.asarray(jax.jit(jax.grad(
        lambda p: jl(p, jnp.asarray(b)).sum()))(jnp.asarray(a)))
    p = torch.as_tensor(a).requires_grad_()
    t = torch.as_tensor(b).requires_grad_()
    tl(p, t).sum().backward()
    assert _rel(p.grad.numpy(), want) <= 1e-3
    assert not any(x.requires_grad for x in tl.buffers())


def test_shipped_heads_equal_jax():
    """The port's heads are byte copies of the JAX package's, and load
    into both bit for bit."""
    for net in ("vgg", "alex"):
        port_file = (Path(lpips.__file__).parent / "weights"
                     / f"lpips_heads_{net}.npz")
        jax_file = (Path(jax_lpips.__file__).parent / "weights"
                    / f"lpips_heads_{net}.npz")
        assert port_file.read_bytes() == jax_file.read_bytes()
        mod = lpips.load_lpips(net, allow_random=True)
        for i, h in enumerate(jax_lpips._shipped_heads(net)):
            np.testing.assert_array_equal(getattr(mod, f"head{i}").numpy(),
                                          np.asarray(h))


def _write_trunk(path, net):
    """JAX's random trunk as a torchvision ``features`` state dict
    (OIHW, ``features.{i}.weight``/``.bias``)."""
    convs = jax_lpips._random_trunk(net, jax.random.PRNGKey(0))
    sd = {}
    for i, (w, b) in zip(FEATURE_IDX[net], convs):
        sd[f"features.{i}.weight"] = np.asarray(w).transpose(3, 2, 0, 1)
        sd[f"features.{i}.bias"] = np.asarray(b)
    np.savez(path, **sd)
    return sd


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_trunk_file_loads_in_both(net, tmp_path):
    """A trunk file read by both ``load_lpips(weights_path=...)`` (and by
    the port from a torch ``.pth`` of the same tensors): numerically
    matched in both, equal distances (1e-4 relative)."""
    sd = _write_trunk(tmp_path / "trunk.npz", net)
    jl = jax_lpips.load_lpips(net, weights_path=str(tmp_path / "trunk.npz"))
    tl = lpips.load_lpips(net, weights_path=str(tmp_path / "trunk.npz"))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               tmp_path / "trunk.pth")
    tp = lpips.load_lpips(net, weights_path=str(tmp_path / "trunk.pth"))
    assert jl.numerically_matched and tl.numerically_matched \
        and tp.numerically_matched
    a, b = _images(2, 32 if net == "vgg" else 64, seed=3)
    want = np.asarray(jl(jnp.asarray(a), jnp.asarray(b)))
    for mod in (tl, tp):
        got = mod(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_no_trunk_raises_or_warns(monkeypatch):
    """Without a trunk file, ``allow_random=False`` raises
    FileNotFoundError in both packages; ``allow_random=True`` warns and
    is not numerically matched."""
    monkeypatch.delenv("INSTANTAVATAR_LPIPS_WEIGHTS", raising=False)
    for net in ("vgg", "alex"):
        with pytest.raises(FileNotFoundError):
            jax_lpips.load_lpips(net)
        with pytest.raises(FileNotFoundError, match="trunk"):
            lpips.load_lpips(net)
        with pytest.warns(UserWarning, match="RANDOM"):
            mod = lpips.load_lpips(net, allow_random=True)
        assert not mod.numerically_matched
    with pytest.raises(ValueError, match="vgg or alex"):
        lpips.load_lpips("squeeze", allow_random=True)


def test_ngp_loss_lpips_term_matches_jax():
    """``ngp_loss`` with w_lpips 0.01 (VGG, JAX's trunk) and the depth
    term on a (2, 32, 32, 3) patch stack: ``loss_lpips``, the total 1e-4
    relative, the rgb gradient 1e-3 L2-relative; flat rays take no
    LPIPS term."""
    params = jax_lpips.LPIPSParams(
        convs=jax_lpips._random_trunk("vgg", jax.random.PRNGKey(0)),
        heads=jax_lpips._shipped_heads("vgg"))
    jl = jax_lpips.LPIPS("vgg", params)
    tl = convert.lpips_from_numpy(jax.tree.map(np.asarray, params), "vgg")
    rng = np.random.default_rng(11)
    shape = (2, 32, 32)
    pred = {"rgb": rng.uniform(-0.1, 1.1, shape + (3,)).astype(np.float32),
            "alpha": rng.random(shape, dtype=np.float32),
            "depth": rng.uniform(4, 6, shape).astype(np.float32),
            "weights": rng.random(shape + (8,), dtype=np.float32) * 0.2}
    tgt = {"rgb": rng.random(shape + (3,), dtype=np.float32),
           "alpha": (rng.random(shape) > 0.5).astype(np.float32)}
    w = dict(w_rgb=1.0, w_alpha=0.1, w_reg=0.1, w_lpips=0.01,
             w_depth_reg=0.01)
    (_, jls), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_ngp_loss(p, tgt, lpips_fn=jl, **w), has_aux=True))(pred)
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in pred.items()}
    total, tls = ngp_loss(tp, {k: torch.as_tensor(v) for k, v in tgt.items()},
                          lpips_fn=tl, **w)
    total.backward()
    assert set(tls) == set(jls) and "loss_lpips" in tls
    for k in ("loss_lpips", "loss"):
        np.testing.assert_allclose(float(tls[k].detach()), float(jls[k]),
                                   rtol=1e-4, err_msg=k)
    assert _rel(tp["rgb"].grad.numpy(), np.asarray(jg["rgb"])) <= 1e-3
    flat = {k: torch.as_tensor(v.reshape(-1, *v.shape[3:]))
            for k, v in pred.items()}
    _, fl = ngp_loss(flat, {k: torch.as_tensor(v.reshape(-1, *v.shape[3:]))
                            for k, v in tgt.items()}, lpips_fn=tl, **w)
    assert "loss_lpips" not in fl


def test_evaluator_lpips_column(tmp_path, monkeypatch):
    """No trunk: the column is skipped, with JAX's reason. With an alex
    trunk file named by INSTANTAVATAR_LPIPS_WEIGHTS, the column runs in
    both and equals JAX's (1e-4 relative)."""
    monkeypatch.delenv("INSTANTAVATAR_LPIPS_WEIGHTS", raising=False)
    a, b = _images(1, 64, seed=5)
    with pytest.warns(UserWarning, match="LPIPS"):
        ev = metrics.Evaluator()
    with pytest.warns(UserWarning):
        jev = jax_metrics.Evaluator()
    assert ev.lpips_fn is None
    assert ev.lpips_skip_reason == jev.lpips_skip_reason
    assert ev(b[0], a[0]).keys() == {"psnr", "ssim"}
    _write_trunk(tmp_path / "alex.npz", "alex")
    monkeypatch.setenv("INSTANTAVATAR_LPIPS_WEIGHTS",
                       str(tmp_path / "alex.npz"))
    ev, jev = metrics.Evaluator(), jax_metrics.Evaluator()
    assert ev.lpips_skip_reason is None and jev.lpips_fn is not None
    got, want = ev(b[0], a[0]), jev(b[0], a[0])
    assert got.keys() == {"psnr", "ssim", "lpips"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert os.environ["INSTANTAVATAR_LPIPS_WEIGHTS"].endswith("alex.npz")
