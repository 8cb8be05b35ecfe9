"""LPIPS perceptual distance.

Port of ``instantavatar_tpu/losses/lpips.py``: the input scaling layer, a
frozen VGG16 or AlexNet trunk tapped after each ReLU stage, per-channel
unit normalization, the learned 1x1 heads (``max(head, 0)``), spatial
mean and sum over the taps. Images are (N, H, W, 3) in [0, 1] in the
pipeline's BGR order; the module flips them to RGB for the RGB-ordered
scaling layer. The trunk runs as ``F.conv2d``/``F.max_pool2d`` in NCHW,
its weights converted from HWIO once, when they are loaded.

Weights. The published v0.1 heads ship beside this module
(``weights/lpips_heads_{vgg,alex}.npz``, byte copies of the JAX
package's). The trunk is torchvision's in the original and is not in the
repository: ``load_lpips`` reads it from ``weights_path``, then from the
file named by ``INSTANTAVATAR_LPIPS_WEIGHTS``, then from
``weights/lpips_trunk_{net}.npz``; an ``.npz`` or a torch ``.pth`` in the
torchvision ``features.{i}`` layout (see ``_convert_torch_trunk``).
Without one, ``allow_random=True`` draws a random trunk (He-scaled
normal weights, zero biases) from a ``torch.Generator`` seeded 0: a usable
training loss, not comparable to published LPIPS numbers. JAX draws its
random trunk from ``jax.random.PRNGKey(0)``, whose numbers a
``torch.Generator`` cannot reproduce, so a port fit and a JAX fit differ
by their trunks; carry JAX's trunk across with
``instantavatar_torch.convert.lpips_from_numpy`` to compute the same
distance. ``LPIPS.numerically_matched`` is True only with a trunk file
(the heads are the published ones, or the trunk file's own).
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LPIPS", "load_lpips"]

_WEIGHTS_DIR = Path(__file__).parent / "weights"

# the reference's ScalingLayer constants (RGB order)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16: (channels, convs) per stage, tapped after each stage's last ReLU
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# AlexNet: (kernel, c_in, c_out, stride, padding) per conv, one tap each
ALEX_CONVS = ((11, 3, 64, 4, 2), (5, 64, 192, 1, 2), (3, 192, 384, 1, 1),
              (3, 384, 256, 1, 1), (3, 256, 256, 1, 1))
N_CONVS = {"vgg": sum(n for _, n in VGG_STAGES), "alex": len(ALEX_CONVS)}


class LPIPS(torch.nn.Module):
    """LPIPS distance with frozen weights held as buffers.

    Args:
      net: "vgg" or "alex".
      convs: the trunk's (weight (O, I, kh, kw), bias (O,)) in order.
      heads: five (C,) 1x1 head weights.
      numerically_matched: the weights are the published ones.

    ``LPIPS.launches`` and ``LPIPS.rows`` count the distance calls of
    every instance and the pixels of the images they put through the
    trunk (both sides). A call made while a training step is captured
    runs at each replay instead; the step graph counts it there, as it
    counts the kernels (``train/graphs.py``'s ``GRAPH_COUNTED``).
    """

    launches = 0
    rows = 0

    def __init__(self, net: str, convs, heads, *,
                 numerically_matched: bool = False):
        super().__init__()
        if net not in N_CONVS:
            raise ValueError(f"net must be vgg or alex, not {net!r}")
        self.net = net
        self.numerically_matched = numerically_matched
        for i, (w, b) in enumerate(convs):
            self.register_buffer(f"w{i}", torch.tensor(np.array(w, np.float32)))
            self.register_buffer(f"b{i}", torch.tensor(np.array(b, np.float32)))
        for i, h in enumerate(heads):
            self.register_buffer(f"head{i}", torch.tensor(
                np.array(h, np.float32)).reshape(-1))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def conv(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, f"w{i}"), getattr(self, f"b{i}")

    def _vgg_taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps, i = [], 0
        for s, (_, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                w, b = self.conv(i)
                x = F.relu(F.conv2d(x, w, b, padding=1))
                i += 1
            taps.append(x)
            if s < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def _alex_taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, (_, _, _, stride, pad) in enumerate(ALEX_CONVS):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            w, b = self.conv(i)
            x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            taps.append(x)
        return taps

    def taps(self, img: torch.Tensor) -> list[torch.Tensor]:
        """(N, H, W, 3) BGR images in [0, 1] -> the trunk's five NCHW
        taps."""
        x = img.float().permute(0, 3, 1, 2).flip(1)        # BGR -> RGB
        x = (x * 2.0 - 1.0 - self.shift) / self.scale
        return self._vgg_taps(x) if self.net == "vgg" else self._alex_taps(x)

    def forward(self, pred: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
        """(N, H, W, 3) images in [0, 1] -> (N,) LPIPS distances."""
        LPIPS.launches += 1
        LPIPS.rows += ((pred.shape[0] + target.shape[0]) * pred.shape[1]
                       * pred.shape[2])
        total = 0.0
        for i, (tp, tt) in enumerate(zip(self.taps(pred), self.taps(target))):
            n_p = tp / torch.linalg.vector_norm(
                tp, dim=1, keepdim=True).clamp_min(1e-10)
            n_t = tt / torch.linalg.vector_norm(
                tt, dim=1, keepdim=True).clamp_min(1e-10)
            w = torch.relu(getattr(self, f"head{i}"))
            dist = torch.einsum("nchw,c->nhw", (n_p - n_t) ** 2, w)
            total = total + dist.mean(dim=(1, 2))
        return total


def _convert_torch_trunk(state: dict, net: str) -> list:
    """A torchvision ``vgg16().features`` / ``alexnet().features`` state
    dict (keys ``{i}.weight``/``{i}.bias`` or ``features.{i}.*``, OIHW
    float32; vgg16 convs at 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28,
    alexnet's at 0, 3, 6, 8, 10) -> [(weight OIHW, bias), ...] in features
    order. Written where torchvision is installed with::

        sd = torchvision.models.vgg16(weights="IMAGENET1K_V1")\\
             .features.state_dict()
        np.savez("lpips_trunk_vgg.npz", **{k: v.numpy() for k, v in sd.items()})
    """
    idx = sorted({int(k.split(".")[0 if k[0].isdigit() else 1])
                  for k in state if k.endswith("weight")
                  and (k[0].isdigit() or k.startswith("features."))})
    convs = []
    for i in idx:
        for prefix in (f"{i}.", f"features.{i}."):
            if prefix + "weight" in state:
                convs.append((np.asarray(state[prefix + "weight"], np.float32),
                              np.asarray(state[prefix + "bias"], np.float32)))
                break
    return convs


def _convert_torch_heads(state: dict) -> list:
    return [np.asarray(state[f"lin{i}.model.1.weight"], np.float32)
            .reshape(-1) for i in range(5)]


def _random_trunk(net: str, generator: torch.Generator) -> list:
    """He-scaled normal weights and zero biases, drawn from
    ``generator`` (the training-loss fallback)."""
    shapes = []
    if net == "vgg":
        c_in = 3
        for ch, n in VGG_STAGES:
            for _ in range(n):
                shapes.append((ch, c_in, 3, 3))
                c_in = ch
    else:
        shapes = [(co, ci, k, k) for k, ci, co, _, _ in ALEX_CONVS]
    return [(torch.randn(s, generator=generator) * np.sqrt(2.0 / np.prod(s[1:])),
             torch.zeros(s[0])) for s in shapes]


def _shipped_heads(net: str) -> list:
    raw = np.load(_WEIGHTS_DIR / f"lpips_heads_{net}.npz")
    return [np.asarray(raw[f"head{i}"], np.float32) for i in range(5)]


def _read_weights(path: str) -> dict:
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=False))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_lpips(net: str = "vgg", weights_path: str | None = None,
               allow_random: bool = False, *,
               device: torch.device | str = "cpu") -> LPIPS:
    """Build an LPIPS module on ``device``.

    Trunk: from ``weights_path``, else ``$INSTANTAVATAR_LPIPS_WEIGHTS``,
    else ``weights/lpips_trunk_{net}.npz``; without any, a random trunk
    when ``allow_random`` (with a warning), else ``FileNotFoundError``.
    Heads: from the trunk file when it has ``lin{i}.model.1.weight`` keys,
    else the shipped published heads."""
    if net not in N_CONVS:
        raise ValueError(f"net must be vgg or alex, not {net!r}")
    path = weights_path or os.environ.get("INSTANTAVATAR_LPIPS_WEIGHTS")
    if not path:
        default = _WEIGHTS_DIR / f"lpips_trunk_{net}.npz"
        if default.exists():
            path = str(default)
    convs, heads = None, None
    if path and os.path.exists(path):
        raw = _read_weights(path)
        convs = _convert_torch_trunk(raw, net) or None
        try:
            heads = _convert_torch_heads(raw)
        except KeyError:
            heads = None
    real_trunk = convs is not None
    if heads is None:
        heads = _shipped_heads(net)
    if convs is None:
        if not allow_random:
            raise FileNotFoundError(
                "no LPIPS trunk weights available (set "
                "INSTANTAVATAR_LPIPS_WEIGHTS to a torchvision "
                f"{net} state dict .pth/.npz, or pass weights_path; "
                "allow_random=True enables a training-only random-feature "
                "fallback)")
        warnings.warn(
            f"LPIPS({net}): no trunk weights found — using a deterministic "
            "RANDOM-feature trunk. Fine as a training loss; NOT comparable "
            "to published LPIPS numbers.", stacklevel=2)
        convs = _random_trunk(net, torch.Generator().manual_seed(0))
    if len(convs) != N_CONVS[net]:
        raise ValueError(
            f"LPIPS({net}): trunk has {len(convs)} convs, expected "
            f"{N_CONVS[net]} — wrong state dict?")
    return LPIPS(net, convs, heads,
                 numerically_matched=real_trunk).to(device)
