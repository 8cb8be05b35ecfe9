"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the hand
CUDA kernel against its plain version on the card, the field's
no-autograd rule for the kernel head, and one training step on the card
against the same step on the CPU. They skip where there is no card. This
file imports no jax; on a machine that has only PyTorch, skip the
jax-loading conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from instantavatar_torch.kernels import fused_field_head, fused_field_head_ref
from instantavatar_torch.models import VoxelTriplaneField

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_torch_train_golden as golden_tool  # noqa: E402  (numpy only)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
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
    with pytest.raises(NotImplementedError, match="forward-only"):
        field.apply(x, x[0], one)
    with torch.no_grad():
        color, sigma = field.apply(x, x[0], one)
    assert color.shape == (10, 3) and sigma.shape == (10,)


def test_training_head_on_card(cuda):
    """A training step cannot reach the kernel head under autograd: the
    fused head raises (and so does the kernel wrapper itself given a
    tensor that needs a gradient); the ``_mlp`` head trains."""
    field = VoxelTriplaneField(voxel_res=4, plane_res=8, device=cuda)
    field.init(torch.Generator(device=cuda).manual_seed(0))
    x = torch.rand((64, 3), device=cuda)
    one = torch.ones(3, device=cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        field.apply(x, 0.5 * one, one, head="fused")
    enc = torch.zeros((8, 56), dtype=torch.bfloat16, device=cuda,
                      requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_field_head(enc, *field._head_args())
    color, sigma = field.apply(x, 0.5 * one, one, head="mlp")
    (color.sum() + sigma.sum()).backward()
    assert field.voxel.grad is not None and field.sigma_w[0].grad.abs().sum() > 0


@pytest.fixture(scope="module")
def golden_runs(cuda):
    """The training golden replayed on the card and on the CPU."""
    return (golden_tool.replay_golden(cuda),
            golden_tool.replay_golden(torch.device("cpu")))


@pytest.mark.parametrize("i", [0, 1])
def test_training_step_on_card_matches_cpu(golden_runs, i):
    """The training golden's update step (i=0) and plain step (i=1) on the
    card against the same step on the CPU, within the CPU tests'
    tolerances against JAX (losses rtol 1e-3, reg_density atol 5e-5,
    per-leaf gradients 1.5e-2 L2-relative, the updated grid exactly)."""
    card, cpu = golden_runs
    gaps = golden_tool.step_gaps(card[i], cpu[i], ref="")
    assert golden_tool.gaps_within_tolerance(gaps), gaps
