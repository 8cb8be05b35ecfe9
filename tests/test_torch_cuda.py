"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the hand
CUDA kernel against its plain version on the card, and the field's
no-autograd rule. They skip where there is no card. This file imports no
jax; on a machine that has only PyTorch, skip the jax-loading conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from instantavatar_torch.kernels import fused_field_head, fused_field_head_ref
from instantavatar_torch.models import VoxelTriplaneField

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _head(M, E, seed, device):
    g = np.random.default_rng(seed)
    dims_s, dims_c = [(E, 64), (64, 16)], [(15, 64), (64, 64), (64, 3)]

    def t(a, dt):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dt)
    ws = [t(g.standard_normal(d) * np.sqrt(2 / d[0]), torch.bfloat16)
          for d in dims_s + dims_c]
    bs = [t(0.1 * g.standard_normal(d[1]), torch.float32)
          for d in dims_s + dims_c]
    enc = t(g.standard_normal((M, E)), torch.bfloat16)
    return enc, ws[:2], bs[:2], ws[2:], bs[2:]


@pytest.mark.parametrize("M", [1, 1000, 3001])
def test_kernel_matches_plain_on_card(cuda, M):
    """Same numerics, different fp32 summation order: an occasional hidden
    unit's bf16 rounding flips by one ulp; atol 2e-3 (as on the CPU
    against the Pallas kernel)."""
    enc, sw, sb, cw, cb = _head(M, 56, M, cuda)
    before = fused_field_head.launches
    with torch.no_grad():
        c, s = fused_field_head(enc, sw, sb, cw, cb)
        rc, rs = fused_field_head_ref(enc, sw, sb, cw, cb)
    torch.cuda.synchronize()
    assert fused_field_head.launches == before + 1
    assert c.shape == (M, 3) and s.shape == (M,)
    assert (c - rc).abs().max().item() <= 2e-3
    assert (s - rs).abs().max().item() <= 2e-3


def test_kernel_rejects_bad_inputs(cuda):
    enc, sw, sb, cw, cb = _head(64, 56, 0, cuda)
    with torch.no_grad():
        with pytest.raises(TypeError):
            fused_field_head(enc.float(), sw, sb, cw, cb)
        with pytest.raises(ValueError):
            fused_field_head(enc[:, :48].contiguous(), sw, sb, cw, cb)
        with pytest.raises(ValueError):
            fused_field_head(enc.t().contiguous().t(), sw, sb, cw, cb)


def test_field_refuses_autograd_on_cuda(cuda):
    field = VoxelTriplaneField(voxel_res=4, plane_res=8, device=cuda)
    x = torch.zeros((10, 3), device=cuda)
    one = torch.ones(3, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        field.apply(x, x[0], one)
    with torch.no_grad():
        color, sigma = field.apply(x, x[0], one)
    assert color.shape == (10, 3) and sigma.shape == (10,)
