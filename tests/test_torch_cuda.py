"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the hand
CUDA kernel against its plain version on the card, the field's
no-autograd rule for the kernel head, one training step on the card
against the same step on the CPU, the NGP hash encode and field, the
nearest-vertex SMPL deformer (deform and bake) and LPIPS on the card
against the CPU, the eval modes' frames (the head launched in each) and
the triplane field on the card against the CPU. They skip where there is
no card. This
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
