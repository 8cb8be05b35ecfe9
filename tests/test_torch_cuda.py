"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the hand
CUDA kernels (the field head; the hash encode, forward and both
backwards, eager and inside a captured graph) against their plain
versions on the card, the field's
no-autograd rule for the kernel head, one training step on the card
against the same step on the CPU, the NGP hash encode and field, the
nearest-vertex SMPL deformer (deform and bake) and LPIPS on the card
against the CPU, the eval modes' frames (the head launched in each),
the triplane field on the card against the CPU, the training step
captured as CUDA graphs against the eager step (single-device and the DP
step on one NCCL rank), the per-pose grid builds on graphs against the
eager builds, the flat and the ray-bundle frames and
``make_dp_render``'s shards captured as CUDA graphs against the eager
ones, and a frame graph replayed after an in-place parameter update.
They skip where there is no card. This
file imports no jax; on a machine that has only PyTorch, skip the
jax-loading conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import sys
from pathlib import Path

import pytest
import torch

from instantavatar_torch.kernels import (COUNTED, fused_field_head,
                                         fused_field_head_ref,
                                         hash_encode_cuda, head_wave_rows)
from instantavatar_torch.models import VoxelTriplaneField

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import make_torch_train_golden as golden_tool  # noqa: E402  (numpy only)
from chip_smoke import (ENCODE_FEAT_TOL, ENCODE_GRAD_RTOL,  # noqa: E402
                        HEAD_EXACT_TOL, encode_check, encode_inputs,
                        head_agrees, head_float64, head_gap, head_inputs)

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
    """``hash_encode`` at the default 16 x 2 @ 2^19 grid on the card (the
    CUDA kernel, forward and backward) against the CPU (the plain
    version) on the same numpy-seeded points (0, 1, lattice corners,
    outside [0, 1]): slots exactly, features 1e-6, the table's and the
    points' gradients 1e-5 L2-relative (atomic adds sum in another
    order); ``NGPField.apply`` 1e-5."""
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
    launches = hash_encode_cuda.launches
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        tt = torch.as_tensor(table, device=dev).requires_grad_()
        f = hash_encode(tt, xt, cfg)
        (f * torch.as_tensor(ct, device=dev)).sum().backward()
        res.append([hash_slots(xt.detach(), cfg).cpu(), f.detach().cpu(),
                    tt.grad.cpu(), xt.grad.cpu()])
    # the kernel ran: forward, the table's and the points' backward
    assert hash_encode_cuda.launches == launches + 3
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


# the feature widths: the compiled vector rows (1, 2, 4, 8) and one that
# the feature loop takes (3)
FEATURES = [1, 2, 4, 8, 3]


def _grid(features: int):
    from instantavatar_torch.ops import HashGridConfig
    return HashGridConfig(n_features=features)


@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("n", [1, 17, 2 ** 19 + 1])
def test_hash_encode_kernel_matches_plain_on_card(cuda, n, F):
    """The hash-encode kernel against ``hash_encode_ref`` and
    ``hash_encode_backward_ref`` on the card, on numpy-seeded inputs with
    boundary, lattice and out-of-range points, at the default grid with F
    features per row: features within ENCODE_FEAT_TOL absolute, the
    table's and the points' gradients within ENCODE_GRAD_RTOL L2-relative
    (fp32 atomics sum in another order); one forward and two backward
    launches."""
    r = encode_check(cuda, n, seed=n, cfg=_grid(F))
    assert r["launches"] == 3
    assert r["feat_err"] <= ENCODE_FEAT_TOL, r
    assert r["grad_table_rel"] <= ENCODE_GRAD_RTOL, r
    assert r["grad_x_rel"] <= ENCODE_GRAD_RTOL, r


@pytest.mark.parametrize("F", FEATURES)
def test_hash_encode_deterministic_backward_on_card(cuda, F):
    """Under deterministic algorithms the table's gradient (rows sorted,
    runs summed in point order, in chunks) is bit-identical on two runs,
    and within ENCODE_GRAD_RTOL of the plain version, at F features per
    row; the rows, the run pieces, their join and the points' gradient
    are four launches beside the forward."""
    one, two = (encode_check(cuda, 70_001, seed=3, deterministic=True,
                             keep=True, cfg=_grid(F)) for _ in range(2))
    assert one["launches"] == 5
    assert one["grad_table_rel"] <= ENCODE_GRAD_RTOL, one
    assert one["grad_x_rel"] <= ENCODE_GRAD_RTOL, one
    for k in ("out", "grad_table", "grad_x"):
        assert torch.equal(one[k], two[k]), k


@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("deterministic", [False, True])
def test_hash_encode_kernel_in_cuda_graph(cuda, deterministic, F):
    """The kernel, forward and backward, captured in a CUDA graph at F
    features per row: each replay equals the eager call (bit for bit but
    for the atomic table gradient, within ENCODE_GRAD_RTOL), and the
    graph's launches, taken off the counters at capture, come back once
    per replay."""
    from instantavatar_torch.kernels import add_replay, captured_counts
    from instantavatar_torch.ops import level_resolutions
    res = level_resolutions(_grid(F))
    table, x, ct = encode_inputs(5_000, 11, cuda, _grid(F))
    tt, xt = table.requires_grad_(), x.requires_grad_()

    def body():
        out = hash_encode_cuda(tt, xt, res)
        return (out, *torch.autograd.grad(out, (tt, xt), ct))
    torch.use_deterministic_algorithms(deterministic)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = [t.clone() for t in body()]
        torch.cuda.current_stream().wait_stream(side)
        before = (hash_encode_cuda.launches, hash_encode_cuda.rows)
        graph = torch.cuda.CUDAGraph()
        with captured_counts() as launched, torch.cuda.graph(graph):
            static = body()
    finally:
        torch.use_deterministic_algorithms(False)
    per = launched[COUNTED.index(hash_encode_cuda)]
    assert per == ((5, 5 * 5_000) if deterministic else (3, 3 * 5_000))
    assert (hash_encode_cuda.launches, hash_encode_cuda.rows) == before
    for i in range(2):
        graph.replay()
        add_replay(launched)
        torch.cuda.synchronize()
        assert hash_encode_cuda.launches == before[0] + (i + 1) * per[0]
        assert torch.equal(static[0], eager[0])
        assert torch.equal(static[2], eager[2])
        if deterministic:
            assert torch.equal(static[1], eager[1])
        else:
            rel = (static[1] - eager[1]).norm() / eager[1].norm()
            assert float(rel) <= ENCODE_GRAD_RTOL


def test_hash_encode_kernel_other_grids_on_card(cuda):
    """The kernel against the plain version on ``chip_smoke``'s other
    grids (40 levels among them, past the earlier limit of 32), default and
    deterministic mode, by the same tolerances."""
    from chip_smoke import encode_grids
    for cfg in encode_grids():
        for det in (False, True):
            r = encode_check(cuda, 3_001, seed=4, deterministic=det, cfg=cfg)
            assert r["launches"] == (5 if det else 3)
            assert r["feat_err"] <= ENCODE_FEAT_TOL, (cfg, r)
            assert r["grad_table_rel"] <= ENCODE_GRAD_RTOL, (cfg, r)
            assert r["grad_x_rel"] <= ENCODE_GRAD_RTOL, (cfg, r)


def test_hash_encode_kernel_nan_point(cuda):
    """A NaN point indexes inside its levels (the cell is clamped after
    the conversion) and gives NaN features, as the plain version does;
    the other points' features and the backward are unaffected."""
    from instantavatar_torch.ops import (HashGridConfig, hash_encode_ref,
                                         level_resolutions)
    cfg = HashGridConfig()
    table, x, ct = encode_inputs(1000, 12, cuda)
    x[7, 1] = float("nan")
    tt = table.clone().requires_grad_()
    feats = hash_encode_cuda(tt, x, level_resolutions(cfg))
    feats.backward(ct)
    torch.cuda.synchronize()
    out, ref = feats.detach(), hash_encode_ref(table, x, cfg)
    assert bool(torch.isnan(out[7]).all()) and bool(torch.isnan(ref[7]).all())
    others = torch.ones(1000, dtype=torch.bool, device=cuda)
    others[7] = False
    assert float((out[others] - ref[others]).abs().max()) <= ENCODE_FEAT_TOL
    assert int(torch.isnan(tt.grad).any(-1).sum()) <= 16 * 8


def test_hash_encode_kernel_empty_input(cuda):
    """N = 0: an empty (0, L * F) result and a zero table gradient, with
    no launch."""
    from instantavatar_torch.ops import (HashGridConfig, hash_encode,
                                         level_resolutions)
    cfg = HashGridConfig()
    table = torch.zeros((16, cfg.table_size, 2), device=cuda,
                        requires_grad=True)
    x = torch.empty((0, 3), device=cuda, requires_grad=True)
    before = hash_encode_cuda.launches
    out = hash_encode_cuda(table, x, level_resolutions(cfg))
    assert out.shape == (0, 32) and out.device.type == "cuda"
    out.sum().backward()
    assert table.grad is not None and not bool(table.grad.any())
    assert x.grad.shape == (0, 3)
    out = hash_encode(table, torch.empty((2, 0, 3), device=cuda), cfg)
    assert out.shape == (2, 0, 32)
    torch.cuda.synchronize()
    assert hash_encode_cuda.launches == before


def test_smpl_deformer_on_card_matches_cpu(cuda):
    """The nearest-vertex SMPLDeformer at SMPL's width (the 7,008-vertex
    toy body) on the card against the CPU: ``prepare`` 1e-5, ``deform``'s
    valid equal and xc 1e-5 where the nearest vertex agrees (exact ties
    and distances within 1e-6 of the threshold aside), and the bake's
    rows and sigma likewise."""
    import numpy as np
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.ops import nearest_vertex
    g = np.random.default_rng(0)
    pose = {"betas": 0.5 * g.standard_normal((1, 10)),
            "body_pose": 0.3 * g.standard_normal((1, 69)),
            "global_orient": 0.4 * g.standard_normal((1, 3)),
            "transl": np.array([[0.1, 0.2, 4.0]])}
    outs = []
    for dev in (cuda, torch.device("cpu")):
        d = SMPLDeformer(toy_smpl_model(ring_size=16, bone_rings=18,
                                        device=dev))
        args = [torch.as_tensor(pose[k], dtype=torch.float32, device=dev)
                for k in ("betas", "body_pose", "global_orient", "transl")]
        cano = d.build_canonical(args[0])
        frame = d.prepare(cano, *args)
        if not outs:
            v = frame.verts_smpl.cpu().numpy()
            pts = np.concatenate([
                v[g.integers(0, len(v), 20000)]
                + 0.03 * g.standard_normal((20000, 3)),
                g.uniform(v.min(0), v.max(0), (20000, 3))]).astype(np.float32)
        p = torch.as_tensor(pts, device=dev)
        xc, valid = d.deform(frame, p)
        rows, sig = d.bake_packed_cache(cano, frame, p,
                                        lambda x: 10 * torch.sin(3 * x).sum(-1))
        d2, idx = nearest_vertex(p, frame.verts_smpl)
        outs.append([t.detach().cpu() for t in (frame.T_inv, frame.verts_smpl,
                                                xc, valid, rows, sig, d2, idx)])
    (T0, v0, x0, ok0, r0, s0, d0, i0), (T1, v1, x1, ok1, r1, s1, d1, i1) = outs
    torch.testing.assert_close(T0, T1, rtol=0, atol=1e-5)
    torch.testing.assert_close(v0, v1, rtol=0, atol=1e-5)
    torch.testing.assert_close(d0, d1, rtol=0, atol=1e-5)
    same = (i0 == i1) & ((d1 - 0.05 ** 2).abs() > 1e-6)
    assert float(same.float().mean()) >= 0.999
    assert torch.equal(ok0[same], ok1[same]) and 0.1 < float(ok1.float().mean())
    torch.testing.assert_close(x0[same], x1[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(r0[same], r1[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(s0[same], s1[same], rtol=0, atol=1e-4)


def test_lpips_on_card_matches_cpu(cuda):
    """LPIPS (VGG on the fitting step's 4 x 32 x 32 patch stack, AlexNet
    on 64 px frames; random trunk) on the card with TF32 off against the
    CPU: distances 1e-4 relative, the prediction's gradient 1e-3
    L2-relative, the CPU tests' bound against JAX (cuDNN's fp32 backward
    sums in another order than the CPU's: measured 4.3e-4 on VGG)."""
    import warnings
    import numpy as np
    from instantavatar_torch.losses import load_lpips
    g = np.random.default_rng(1)
    for net, size in (("vgg", 32), ("alex", 64)):
        a = g.random((4, size, size, 3), dtype=np.float32)
        b = np.clip(a + 0.2 * g.standard_normal(a.shape), 0, 1) \
            .astype(np.float32)
        res = []
        for dev in (cuda, torch.device("cpu")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mod = load_lpips(net, allow_random=True, device=dev)
            p = torch.as_tensor(a, device=dev).requires_grad_()
            dist = mod(p, torch.as_tensor(b, device=dev))
            dist.sum().backward()
            res.append((dist.detach().cpu(), p.grad.cpu()))
        (d0, g0), (d1, g1) = res
        torch.testing.assert_close(d0, d1, rtol=1e-4, atol=0)
        assert float((g0 - g1).norm() / g1.norm()) <= 1e-3, net


@pytest.mark.parametrize("mode", [
    {"eval_sampling": "windows"}, {"eval_sampling": "dense"},
    {"eval_sampling": "dense", "cache_fused_probe": True},
    {"use_warp_cache": False}, {"shared_corner_eval": True},
    {"flat_tile_rows": True}, {"term_T": None}],
    ids=["windows", "dense", "probe", "uncached", "shared", "tiled",
         "no_term"])
def test_eval_modes_on_card_match_cpu(cuda, mode):
    """A 48 px frame of the opaque seeded avatar (golden-96's small
    configuration) in each ray-bundle and ablation mode on the card, the
    head being the kernel, against the same mode on the CPU (its plain
    head): rgb PSNR >= 35 dB (golden-96's card bound) and the head
    launched at least once."""
    import numpy as np
    from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
    from chip_smoke import make_avatar, psnr
    H = 48
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    ro, rd = make_ray_grid(K, np.eye(4), H, H)
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "rays_o": ro.reshape(-1, 3), "rays_d": rd.reshape(-1, 3),
             "betas": np.zeros(10, np.float32),
             "body_pose": np.zeros(69, np.float32),
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    rgbs = []
    for dev in (cuda, torch.device("cpu")):
        av = make_avatar(dev, deformer_res=32, grid_size=32, voxel_res=16,
                         plane_res=32, param_seed=3, sigma_bias=100.0,
                         shell_margin=0.08)
        for k, v in mode.items():
            setattr(av, k, v)
        state = av.init(np.zeros(10, np.float32))
        grid = av.build_pose_grid(state, batch)
        before = fused_field_head.launches
        out = av.render_frame(state, batch, grid=grid, image_shape=(H, H))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fused_field_head.launches > before
        rgbs.append(out["rgb"].cpu())
    assert bool(torch.isfinite(rgbs[0]).all())
    assert psnr(rgbs[0], rgbs[1]) >= 35.0


def test_triplane_field_on_card_matches_cpu(cuda):
    """TriPlaneField at full width (3 x 32 x 256^2) on the card with TF32
    off against the CPU: colour, sigma 1e-5; the plane gradients 1e-4
    L2-relative (an fp32 index_add_ in another order)."""
    import numpy as np
    from instantavatar_torch.models import TriPlaneField
    g = np.random.default_rng(2)
    x = g.uniform(-1.1, 1.1, (20000, 3)).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        field = TriPlaneField(device=dev)
        field.init(torch.Generator().manual_seed(0))
        one = torch.ones(3, device=dev)
        c, s = field.apply(torch.as_tensor(x, device=dev), 0 * one, 2 * one,
                           head="mlp")
        (c.sum() + 0.01 * s.sum()).backward()
        res.append((c.detach().cpu(), s.detach().cpu(),
                    field.plane_xy.grad.cpu()))
    (c0, s0, g0), (c1, s1, g1) = res
    torch.testing.assert_close(c0, c1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s0, s1, rtol=1e-5, atol=1e-5)
    assert float((g0 - g1).norm() / g1.norm()) <= 1e-4


# -- the parallel layer on the card ------------------------------------------

def _rank_results(work, n):
    return [torch.load(work / f"rank{r}.pt", map_location="cpu",
                       weights_only=False) for r in range(n)]


def _seeded_single_step(cuda, draws):
    """The port's single-process update step of the seeded golden avatar
    on the golden batch 0, with ``draws`` moved to the card."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_workers as workers
    from instantavatar_torch.train import StepDraws
    avatar, state = workers.seeded_golden_avatar(cuda)
    state, losses = avatar.train_step_update(
        state, golden_tool.scene_batches()[0],
        StepDraws(*(None if t is None else t.to(cuda) for t in draws)))
    rec = workers.step_record(avatar, state, losses)
    return {k: ({n: t.cpu() for n, t in v.items()} if k in ("grads",
                                                           "params")
                else v.cpu() if torch.is_tensor(v) else v)
            for k, v in rec.items()}


def test_dp_step_nccl_one_rank_on_card(cuda, tmp_path):
    """One spawned NCCL rank's DP update step (its all_reduce the identity)
    equals the single-process step with the same draws, exactly."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_workers as workers
    from instantavatar_torch.parallel import run_ranks
    torch.save({"device": "cuda:0", "seed": 11}, tmp_path / "inputs.pt")
    run_ranks(workers.seeded_step_rank, 1, backend="nccl",
              store_dir=tmp_path, args=(str(tmp_path),), timeout=300.0)
    (r0,) = _rank_results(tmp_path, 1)
    one = _seeded_single_step(cuda, r0["draws"])
    assert r0["losses"] == one["losses"]
    for n, p in one["params"].items():
        assert torch.equal(r0["params"][n], p), n
    assert torch.equal(r0["occupancy"], one["occupancy"])


def test_dp_step_gloo_two_ranks_on_card(cuda, tmp_path):
    """Two spawned gloo ranks on the one card: parameters bit-identical on
    both after the step; losses within 1e-4 relative of the single-process
    step on the concatenated batch with the concatenated draws; the
    updated grid exactly."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_workers as workers
    from instantavatar_torch.parallel import run_ranks
    torch.save({"device": "cuda:0", "seed": 11}, tmp_path / "inputs.pt")
    run_ranks(workers.seeded_step_rank, 2, backend="gloo",
              store_dir=tmp_path, args=(str(tmp_path),), timeout=300.0)
    r0, r1 = _rank_results(tmp_path, 2)
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    d0, d1 = r0["draws"], r1["draws"]
    one = _seeded_single_step(cuda, (torch.cat([d0[0], d1[0]]),
                                     torch.cat([d0[1], d1[1]]), d0[2]))
    for k in ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
              "reg_density", "loss"):
        assert abs(r0["losses"][k] / one["losses"][k] - 1) <= 1e-4, k
    assert torch.equal(r0["occupancy"], one["occupancy"])


def test_dp_render_two_ranks_on_card(cuda, tmp_path):
    """Two spawned gloo ranks render the 48 px frame's bands on the card
    (each launching the kernel head) in both layouts: both hold the same
    gathered frame, within 1e-4 of the two bands rendered in this process
    and >= 40 dB from the single-device frame."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_workers as workers
    from chip_smoke import make_avatar, psnr
    from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
    from instantavatar_torch.parallel import (dp_render_frame, make_mesh,
                                              run_ranks)
    H = 48
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    frame = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "betas": np.zeros(10, np.float32),
             "body_pose": np.zeros(69, np.float32),
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    ro, rd = make_ray_grid(K, np.eye(4), H, H)
    rays = {"rays_o": ro[16:32, 16:32].reshape(-1, 3),
            "rays_d": rd[16:32, 16:32].reshape(-1, 3),
            **{k: frame[k] for k in ("betas", "body_pose", "global_orient",
                                     "transl")}}
    av = make_avatar(cuda, deformer_res=32, grid_size=32, voxel_res=16,
                     plane_res=32, param_seed=3, sigma_bias=100.0,
                     shell_margin=0.08)
    state = av.init(np.zeros(10, np.float32))
    grid = av.build_pose_grid(state, frame)
    spec = {"device": "cuda:0", "voxel_res": 16, "plane_res": 32,
            "snarf": dict(resolution=32, cano_pose="a_pose", n_iters=6,
                          cand_cap=2, n_init_active=4),
            "avatar": {k: getattr(av, k) for k in (
                "n_steps", "k_cap", "grid_size", "eval_n_steps",
                "cache_n_cand", "shell_margin")},
            "field": av.field.state_dict(), "cano": state.deformer_cano,
            "center": state.center, "scale": state.scale, "grid": grid}
    torch.save({"scene": spec, "frame": frame, "image_shape": (H, H),
                "rays": rays}, tmp_path / "inputs.pt")
    run_ranks(workers.card_render_rank, 2, backend="gloo",
              store_dir=tmp_path, args=(str(tmp_path),), timeout=300.0)
    r0, r1 = _rank_results(tmp_path, 2)
    assert r0["launches"] > 0 and r1["launches"] > 0
    single = av.render_frame(state, frame, grid=grid, image_shape=(H, H))
    for layout in ("stride", "band"):
        ref = dp_render_frame(av, make_mesh(n_ray=2), state, frame, grid,
                              (H, H), layout=layout)
        for k in ("rgb", "alpha"):
            assert torch.equal(r0[layout][k], r1[layout][k])
            assert float((r0[layout][k] - ref[k].cpu()).abs().max()) \
                <= 1e-4, (layout, k)
        assert psnr(r0[layout]["rgb"], single["rgb"].cpu()) >= 40.0


# -- the captured training step ------------------------------------------------

def _graph_run(cuda, graph: bool, steps: int = 6):
    """``steps`` steps of the seeded golden avatar (grid updates every 3
    steps) on the golden batches from one state and one seed, eager or
    on captured graphs; returns the avatar, the state and what the steps
    leave (parameters, moments, counts, grid, last losses)."""
    from instantavatar_torch import convert
    C = golden_tool.CONFIG
    avatar = golden_tool.port_avatar(device=cuda, grid_update_interval=3)
    avatar.field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(C["voxel_res"], C["plane_res"],
                                    C["param_seed"], feat_std=C["feat_std"],
                                    sigma_bias=C["sigma_bias"])))
    batches = golden_tool.scene_batches()
    state = avatar.init(batches[0]["betas"])
    gen = torch.Generator(device=cuda).manual_seed(5)
    for i in range(steps):
        state, losses = avatar.step(state, batches[i % 2], gen, graph=graph)
    torch.cuda.synchronize()
    opt = state.opt_state
    out = [p.detach().clone() for p in avatar.field.parameters()]
    out += [t.clone() for t in opt.moments()[0] + opt.moments()[1]]
    out += [opt.count.clone(), *(g.clone() for g in state.grid)]
    out += [losses[k].clone() for k in sorted(losses)]
    return avatar, state, out


def test_step_graph_replays_the_eager_step_bit_for_bit(cuda):
    """The golden avatar's step captured (grid-update and plain graphs,
    noise on) and replayed for 6 steps leaves the eager steps' parameters,
    Adam moments, count, grid and last losses bit for bit under PyTorch's
    deterministic algorithms; the grid is written in place and the
    step's graphs share one pool."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, eager = _graph_run(cuda, False)
        avatar, state, graph = _graph_run(cuda, True)
    finally:
        torch.use_deterministic_algorithms(False)
    g = avatar.step_graphs
    assert g.captures == 2 and set(g.graphs) == {
        ((True, True, True), None), ((False, False, True), None)}
    assert state.step == 6 and int(state.opt_state.count) == 6
    for i, (a, b) in enumerate(zip(eager, graph, strict=True)):
        assert torch.equal(a, b), i


def test_step_graph_counts_the_head_on_replay(cuda):
    """The fused head's counters: an eager step launches the head once
    (the training bake's sigma sort); a captured step adds its captured
    launches and rows on every replay, and its capture adds only the
    eager warm-up's launch."""
    from instantavatar_torch.train.graphs import StepGraphs
    fused_field_head.launches = fused_field_head.rows = 0
    _graph_run(cuda, False, steps=2)
    eager = (fused_field_head.launches, fused_field_head.rows)
    assert eager[0] == 2 and eager[1] > 0
    fused_field_head.launches = fused_field_head.rows = 0
    avatar, _, _ = _graph_run(cuda, True, steps=2)
    g = avatar.step_graphs
    assert isinstance(g, StepGraphs) and g.captures == 2
    per_graph = {k: c.launched[COUNTED.index(fused_field_head)]
                 for k, c in g.graphs.items()}
    assert all(v == (1, eager[1] // 2) for v in per_graph.values()), \
        per_graph
    # two replays, each warm-up one launch of the same rows
    assert fused_field_head.launches == 2 + g.captures
    assert fused_field_head.rows == eager[1] + g.captures * eager[1] // 2


def _step_left(avatar, state, losses) -> list[torch.Tensor]:
    """What a step leaves: parameters, gradients, Adam moments and
    counts, the grid and the losses (copies)."""
    opt = state.opt_state
    out = [p.detach() for p in avatar.field.parameters()]
    out += [p.grad for p in avatar.field.parameters()]
    out += opt.moments()[0] + opt.moments()[1]
    out += [opt.count, opt.notfinite_count, *state.grid]
    return [t.clone() for t in out + [losses[k] for k in sorted(losses)]]


def test_dp_step_graph_matches_eager_on_one_nccl_rank(cuda, tmp_path):
    """The seeded golden avatar's DP step on a world of one NCCL rank in
    this process (a real group, its all_reduce inside the graph): an
    update step and a plain step, captured and replayed, leave the eager
    DP steps' parameters, gradients, moments, counts, grid and losses bit
    for bit under PyTorch's deterministic algorithms; the graphs are keyed
    by the group."""
    import numpy as np
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_workers as workers
    from instantavatar_torch.parallel import (make_dp_train_step,
                                              make_mesh, rank_draws)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh(n_ray=1)
        batches = golden_tool.scene_batches()
        n = int(np.prod(batches[0]["rays_o"].shape[:-1]))
        runs = []
        for graph in (False, True):
            avatar, state = workers.seeded_golden_avatar(cuda)
            left = []
            for i, update in enumerate((True, False)):
                draws = rank_draws(avatar, mesh, 20 + i, n, update)
                state, losses = make_dp_train_step(
                    avatar, mesh, update, graph=graph)(state, batches[i],
                                                       draws)
                left.append(_step_left(avatar, state, losses))
            runs.append(left)
        g = avatar.step_graphs
        assert g.captures == 2 and {k[1] for k in g.graphs} == {mesh.group}
        assert state.step == 2
        for i in range(2):
            for j, (a, b) in enumerate(zip(*(r[i] for r in runs),
                                           strict=True)):
                assert torch.equal(a, b), (i, j)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def test_grid_graph_returns_the_callers_grid(cuda):
    """Two consecutive graphed ``build_pose_grid`` calls on two poses:
    the first call's grid is unchanged by the second replay (the grids
    are the caller's own), the two differ, and each equals the eager
    build exactly; ``build_test_grid`` on graphs equals its eager build
    exactly (deterministic algorithms)."""
    import numpy as np
    from chip_smoke import make_avatar
    av = make_avatar(cuda, deformer_res=32, grid_size=32, voxel_res=16,
                     plane_res=32, param_seed=3, sigma_bias=100.0,
                     shell_margin=0.08)
    state = av.init(np.zeros(10, np.float32))
    b0 = {"betas": np.zeros(10, np.float32),
          "body_pose": np.zeros(69, np.float32),
          "global_orient": np.zeros(3, np.float32),
          "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    bp = np.zeros(69, np.float32)
    bp[47], bp[50] = 0.9, -0.9
    b1 = {**b0, "body_pose": bp}
    first = av.build_pose_grid(state, b0)
    kept = [t.clone() for t in first]
    second = av.build_pose_grid(state, b1)
    torch.cuda.synchronize()
    for a, k in zip(first, kept):
        assert torch.equal(a, k)
    assert not torch.equal(first.occupancy, second.occupancy)
    for g, b in ((first, b0), (second, b1)):
        for a, e in zip(g, av.build_pose_grid(state, b, graph=False)):
            assert torch.equal(a, e)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graphed = av.build_test_grid(state, b1)
        eager = av.build_test_grid(state, b1, graph=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(graphed.occupancy.sum()) > 0
    for a, e in zip(graphed, eager):
        assert torch.equal(a, e)
    gg = av.grid_graphs
    assert gg.captures == 2 and gg.replays == 3


# -- the flat frame as captured graphs ------------------------------------------

def test_frame_graph_matches_the_eager_frame(cuda):
    """A 48 px turntable of 3 and a new pose through ``render_frames`` on
    captured frame graphs against the same budgeted frames run eagerly on
    the card (``graph=False``): every frame within 1e-6; the head's
    launches rise by the captured launches on each replay; the turntable
    reuses the bake (a reuse graph) and the new pose bakes again."""
    from instantavatar_torch.train import RenderSession
    H = 48
    av, state = _small_avatar(cuda)
    frames = _frames_48()
    grid = av.build_pose_grid(state, frames[0])
    runs = {}
    for graph in (False, True):
        before = fused_field_head.launches
        replays = av.frame_graphs.replays if av.frame_graphs else 0
        runs[graph] = list(av.render_frames(
            state, frames, grid=grid, image_shape=(H, H),
            session=RenderSession(), graph=graph))
        torch.cuda.synchronize()
        runs[graph, "launches"] = fused_field_head.launches - before
    g = av.frame_graphs
    assert g.captures >= 2 and g.replays - replays >= len(frames)
    assert {k.bake for k in g.graphs} == {True, False}   # bake and reuse
    assert runs[True, "launches"] >= len(frames)
    for e, c in zip(runs[False], runs[True]):
        assert e["n_samples"] == c["n_samples"] > 0
        for k in ("rgb", "depth", "alpha", "counter"):
            assert float((e[k] - c[k]).abs().max()) <= 1e-6, k


def _small_avatar(cuda, **knobs):
    import numpy as np
    from chip_smoke import make_avatar
    av = make_avatar(cuda, deformer_res=32, grid_size=32, voxel_res=16,
                     plane_res=32, param_seed=3, sigma_bias=100.0,
                     shell_margin=0.08)
    for k, v in knobs.items():
        setattr(av, k, v)
    return av, av.init(np.zeros(10, np.float32))


def _frames_48(with_rays: bool = False) -> list[dict]:
    """A 48 px turntable of 3 and a new pose (per-pixel rays optional)."""
    import numpy as np
    from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
    H = 48
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    b = {"ray_basis": make_ray_basis(K, np.eye(4)),
         "betas": np.zeros(10, np.float32),
         "body_pose": np.zeros(69, np.float32),
         "global_orient": np.zeros(3, np.float32),
         "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    if with_rays:
        ro, rd = make_ray_grid(K, np.eye(4), H, H)
        b.update(rays_o=ro.reshape(-1, 3), rays_d=rd.reshape(-1, 3))
    frames = [{**b, "global_orient": np.array([0.0, y, 0.0], np.float32)}
              for y in (0.0, 0.4, 0.8)]
    return frames + [{**b, "body_pose": b["body_pose"] + 0.1}]


@pytest.mark.parametrize("mode", ["windows", "dense", "cache_fused_probe",
                                  "uncached"])
def test_ray_frame_graph_matches_the_eager_frame(cuda, mode):
    """Each ray-bundle mode: a 48 px turntable of 3 and a new pose
    through ``render_frames`` on captured ``_rays_frame`` graphs against
    the same budgeted frames run eagerly (``graph=False``), bit for bit
    under deterministic algorithms, and within 1e-6 of the exact-count
    ``render_rays_frame`` through one session of its own (the turntable
    reuses its first bake there too); the head's launches rise on the
    replays (by at least the eager frames' launches)."""
    from instantavatar_torch.train import RenderSession
    knobs = {"windows": dict(eval_sampling="windows"),
             "dense": dict(eval_sampling="dense"),
             "cache_fused_probe": dict(eval_sampling="dense",
                                       cache_fused_probe=True),
             "uncached": dict(use_warp_cache=False)}[mode]
    av, state = _small_avatar(cuda, **knobs)
    frames = _frames_48(with_rays=True)
    grid = av.build_pose_grid(state, frames[0])
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graph in (False, True):
            before = fused_field_head.launches
            runs[graph] = list(av.render_frames(
                state, frames, grid=grid, image_shape=(48, 48),
                session=RenderSession(), graph=graph))
            torch.cuda.synchronize()
            runs[graph, "launches"] = fused_field_head.launches - before
    finally:
        torch.use_deterministic_algorithms(False)
    g = av.frame_graphs
    assert g.captures >= 1 and g.replays >= len(frames)
    assert {k.program for k in g.graphs} == {"_rays_frame"}
    # the eager warm-up before each capture launches the head once more
    assert runs[True, "launches"] >= runs[False, "launches"] > 0
    exact_session = RenderSession()
    for f, e, c in zip(frames, runs[False], runs[True]):
        assert e["n_samples"] == c["n_samples"] > 0
        exact = av.render_rays_frame(state, f, grid, (48, 48),
                                     exact_session)
        for k in ("rgb", "depth", "alpha", "counter"):
            assert torch.equal(e[k], c[k]), k
            assert float((exact[k] - c[k]).abs().max()) <= 1e-6, k


def test_dp_render_graph_matches_eager(cuda):
    """``make_dp_render`` over two ray shards in one process: each shard
    one replay of its ``_eval_render`` graph (one capture for the two
    equal shards), the frame bit-equal to the eager shards' under
    deterministic algorithms, and the head launched inside the graph."""
    import numpy as np
    from instantavatar_torch.parallel import Mesh, make_dp_render
    av, state = _small_avatar(cuda)
    f = _frames_48(with_rays=True)[1]
    b = {**{k: v for k, v in f.items() if k != "ray_basis"},
         "rays_o": f["rays_o"].reshape(48, 48, 3),
         "rays_d": f["rays_d"].reshape(48, 48, 3)}
    grid = av.build_pose_grid(state, b)
    mesh = Mesh(1, 2, 0, 0, None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager = make_dp_render(av, mesh, graph=False)(state, b, grid)
        before = fused_field_head.launches
        graphed = make_dp_render(av, mesh)(state, b, grid)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    g = av.frame_graphs
    assert g.captures == 1 and g.replays == 2
    assert fused_field_head.launches > before
    assert float(np.asarray(graphed["alpha"].cpu()).max()) > 0
    for k in ("rgb", "depth", "alpha", "counter"):
        assert torch.equal(eager[k], graphed[k]), k


def test_frame_graph_reads_updated_parameters(cuda):
    """A flat frame on graphs, then an in-place update of every field
    parameter (as the optimizer makes), then the frame again: no new
    capture, and the replay equals the eager frame at the new parameters
    (not the old frame): the graphs read the parameters at their
    addresses."""
    av, state = _small_avatar(cuda)
    f = _frames_48()[1]
    grid = av.build_pose_grid(state, f)

    def frame(graph):
        out = av.render_frame(state, f, grid=grid, image_shape=(48, 48),
                              graph=graph)
        torch.cuda.synchronize()
        return out
    before = frame(True)
    captures = av.frame_graphs.captures
    with torch.no_grad():
        for p in av.field.parameters():
            p.mul_(0.9).add_(0.01)
    after, eager = frame(True), frame(False)
    assert av.frame_graphs.captures == captures
    assert float((after["rgb"] - before["rgb"]).abs().max()) > 1e-3
    for k in ("rgb", "depth", "alpha", "counter"):
        assert float((after[k] - eager[k]).abs().max()) <= 1e-6, k


# -- the program's spans around captures ----------------------------------------

def test_no_span_opens_while_a_graph_is_captured(cuda):
    """Under a profiler: a span opened while the current stream is being
    captured records nothing and takes no CUDA event, and the capture
    replays; a fresh avatar's first frames capture their grid and frame
    graphs inside ``grid.capture`` and ``frame.capture`` spans, which no
    span opens inside, and each replay span times the device."""
    from torch.profiler import ProfilerActivity, profile

    from instantavatar_torch.train import RenderSession
    from instantavatar_torch.utils import profiling
    x = torch.ones(1024, device=cuda)
    g = torch.cuda.CUDAGraph()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            y = x * 2   # warm-up
        torch.cuda.current_stream().wait_stream(s)
        events = profiling._REC.events_used
        with torch.cuda.graph(g):
            with profiling.span("inside", device=True):
                y = x * 3
        assert profiling._REC.events_used == events
        g.replay()
        torch.cuda.synchronize()
        assert float(y[0]) == 3.0
        av, state = _small_avatar(cuda)
        list(av.render_frames(state, _frames_48(), image_shape=(48, 48),
                              session=RenderSession()))
    recs = profiling.records()
    assert "inside" not in {r.name for r in recs}
    by_id = {r.id: r for r in recs}
    captures = [r for r in recs if r.name.endswith(".capture")]
    assert {r.name for r in captures} >= {"grid.capture", "frame.capture"}
    assert not [r for r in recs if r.parent in {c.id for c in captures}]
    for r in recs:
        if r.parent is not None:
            assert by_id[r.parent].start_ns <= r.start_ns
    s = profiling.summary()
    # one capture span for each capture the owners count
    assert s["spans"]["frame.capture"]["count"] == av.frame_graphs.captures
    assert s["spans"]["grid.capture"]["count"] == av.grid_graphs.captures
    assert av.frame_graphs.captures >= 2 and av.grid_graphs.captures >= 1
    for name in ("frame.replay", "grid.replay"):
        assert s["spans"][name]["device_ms"] > 0, name
    assert set(s["spans"]["frame.replay"]["tags"]) == {"bake", "reuse"}
