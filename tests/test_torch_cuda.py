"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the hand
CUDA kernel against its plain version on the card, the field's
no-autograd rule for the kernel head, one training step on the card
against the same step on the CPU, and the NGP hash encode and field on
the card against the CPU. They skip where there is no card. This
file imports no jax; on a machine that has only PyTorch, skip the
jax-loading conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import sys
from pathlib import Path

import pytest
import torch

from instantavatar_torch.kernels import (fused_field_head,
                                         fused_field_head_ref, head_wave_rows)
from instantavatar_torch.models import VoxelTriplaneField

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import make_torch_train_golden as golden_tool  # noqa: E402  (numpy only)
from chip_smoke import (HEAD_EXACT_TOL, head_agrees,  # noqa: E402
                        head_float64, head_gap, head_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_matches_plain(enc, sw, sb, cw, cb, exact=False):
    """Kernel vs plain version on the card, by ``chip_smoke.py``'s rule:
    on exact-sum inputs within HEAD_EXACT_TOL everywhere; otherwise every
    row within 2e-3 but for at most 1 in 2,000 rows that a bf16 rounding
    tie flips (the tensor cores sum in another fp32 order), those within
    2e-2. Every output is finite."""
    M = enc.shape[0]
    before = fused_field_head.launches
    with torch.no_grad():
        out = fused_field_head(enc, sw, sb, cw, cb)
        ref = fused_field_head_ref(enc, sw, sb, cw, cb)
    torch.cuda.synchronize()
    assert fused_field_head.launches == before + 1
    assert out[0].shape == (M, 3) and out[1].shape == (M,)
    assert bool(torch.isfinite(out[0]).all())
    assert bool(torch.isfinite(out[1]).all())
    if exact:
        assert head_gap(ref, head_float64(enc, sw, sb, cw, cb))[0] \
            <= HEAD_EXACT_TOL
        assert head_gap(out, ref)[0] <= HEAD_EXACT_TOL
    else:
        assert head_agrees(out, ref), head_gap(out, ref)
    return out


# row counts at the edges of the 16-row mma tiles, the 32-row warp tiles
# and the 128-row blocks, and one pass of the persistent grid +- 1 (the
# grid depends on the card, so it is read inside the test)
@pytest.mark.parametrize("M", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                               129, 1000, 3001, "wave-1", "wave+1"])
def test_kernel_matches_plain_on_card(cuda, M):
    if isinstance(M, str):
        M = head_wave_rows(cuda) + (1 if M.endswith("+1") else -1)
    _assert_matches_plain(*head_inputs(M, M, cuda, exact=True), exact=True)
    _assert_matches_plain(*head_inputs(M, M, cuda))


def test_kernel_large_inputs_do_not_leak(cuda):
    """+-128-scale bf16 rows: the exact-sum inputs with the rows scaled by
    128 and the first-layer weights by 1/128, so every product and sum is
    unchanged, taken as 77 rows of a larger tensor whose next rows are
    NaN. The zero padding columns and the zero-filled rows past M must
    not leak a NaN or a non-zero value: the result is the unscaled one."""
    enc, sw, sb, cw, cb = head_inputs(80, 5, cuda, exact=True)
    big = enc.float() * 128
    big[77:] = float("nan")
    big = big.bfloat16()
    sw_big = [(sw[0].float() / 128).bfloat16(), sw[1]]
    out = _assert_matches_plain(big[:77], sw_big, sb, cw, cb, exact=True)
    with torch.no_grad():
        small = fused_field_head(enc[:77], sw, sb, cw, cb)
    assert torch.equal(out[0], small[0]) and torch.equal(out[1], small[1])


def test_kernel_takes_a_row_slice(cuda):
    """``enc`` a row slice of a larger tensor (contiguous, 16-byte aligned
    at row 3, since a row is 112 bytes) gives the rows' own results."""
    enc, sw, sb, cw, cb = head_inputs(1003, 9, cuda)
    sl = enc[3:1003]
    assert sl.is_contiguous() and sl.data_ptr() % 16 == 0
    c, s = _assert_matches_plain(sl, sw, sb, cw, cb)
    with torch.no_grad():
        fc, fs = fused_field_head(enc, sw, sb, cw, cb)
    assert torch.equal(c, fc[3:]) and torch.equal(s, fs[3:])


def test_kernel_rejects_bad_inputs(cuda):
    enc, sw, sb, cw, cb = head_inputs(64, 0, cuda)
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


def test_hash_encode_on_card_matches_cpu(cuda):
    """``hash_encode`` at the default 16 x 2 @ 2^19 grid on the card
    against the CPU on the same numpy-seeded points (0, 1, lattice
    corners, outside [0, 1]): slots exactly, features 1e-6, the table's
    and the points' gradients 1e-5 L2-relative (atomic adds sum in
    another order); ``NGPField.apply`` 1e-5."""
    import numpy as np
    from instantavatar_torch.models import NGPField
    from instantavatar_torch.ops import (HashGridConfig, hash_encode,
                                         hash_slots, level_resolutions)
    cfg = HashGridConfig()
    g = np.random.default_rng(0)
    x = g.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    x[:16], x[16:32] = 0.0, 1.0
    for i, r in enumerate(level_resolutions(cfg)):
        x[32 + 32 * i:64 + 32 * i] = g.integers(0, r + 1, (32, 3)) / r
    table = g.normal(0.0, 0.1, (16, cfg.table_size, 2)).astype(np.float32)
    ct = g.normal(size=(4096, 32)).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        tt = torch.as_tensor(table, device=dev).requires_grad_()
        f = hash_encode(tt, xt, cfg)
        (f * torch.as_tensor(ct, device=dev)).sum().backward()
        res.append([hash_slots(xt.detach(), cfg).cpu(), f.detach().cpu(),
                    tt.grad.cpu(), xt.grad.cpu()])
    (s0, f0, gt0, gx0), (s1, f1, gt1, gx1) = res
    assert torch.equal(s0, s1)
    torch.testing.assert_close(f0, f1, rtol=0, atol=1e-6)
    for a, b in ((gt0, gt1), (gx0, gx1)):
        assert float((a - b).norm() / b.norm()) <= 1e-5
    outs = []
    for dev in (cuda, torch.device("cpu")):
        field = NGPField(device=dev)
        field.init(torch.Generator().manual_seed(0))
        one = torch.ones(3, device=dev)
        c, s = field.apply(torch.as_tensor(x, device=dev) - 0.5, 0 * one, one)
        outs.append((c.detach().cpu(), s.detach().cpu()))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
