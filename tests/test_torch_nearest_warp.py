"""The nearest-vertex warp (``ops.nearest_warp``; on the card the kernels of
``csrc/nearest_vertex.cu`` through ``kernels/nearest_vertex.py``) against
its plain version ``ops.knn.nearest_warp_ref`` (the gather ``T_inv[idx]``
and a batched matmul).

On the CPU:
(a) CPU tensors run the plain version and never build the library, and
    ``SMPLDeformer.deform`` computes what it computed with the gather
    inline: the same canonical points and the same gradients, bit for bit
    (so the CPU tests that hold ``deform`` against JAX see the same
    arithmetic);
(b) the kernels' arithmetic, written with ``index_add_``, is autograd's
    through the plain version: rows 0-2 of the table's gradient are
    grad_xc x [p, 1], row 3 is zero, the points' gradient is R^T grad_xc;
(c) the wrapper's checks raise before anything is built;
(d) M = 0 launches nothing, forward or backward.

On the card (marker ``cuda``; they skip without one), one parametrised
test, each case the kernels beside the plain version on the same card,
with and without a gradient for the points: the fit's own step (262,144
samples against 7,008 vertices, from the demo fit's conf on 540 px
frames, with the counters of captured steps), every sample on one vertex, random indices,
an exact-zero gradient on most rows, ragged M and indices outside the
table, and a CUDA-graph capture. This file imports no jax:

    python -m pytest tests/test_torch_nearest_warp.py -q --noconftest
"""
import sys
from pathlib import Path

import pytest
import torch

from instantavatar_torch.kernels import nearest_vertex as kernel_mod
from instantavatar_torch.kernels.nearest_vertex import (nearest_vertex_cuda,
                                                        nearest_warp_cuda)
from instantavatar_torch.ops import knn

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))   # chip_smoke: the fit step's inputs


def _no_build():
    raise AssertionError("the kernel library was built")


def _old_warp(T_inv, idx, pts):
    """``SMPLDeformer.deform``'s arithmetic before the op: the gather and
    the affine apply inline."""
    T = T_inv[idx]
    return (T[:, :3, :3] @ pts[..., None])[..., 0] + T[:, :3, 3]


def _inputs(M, V, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    T = torch.randn((V, 4, 4), generator=g, device=device, dtype=dtype)
    idx = torch.randint(0, V, (M,), generator=g, device=device)
    pts = torch.randn((M, 3), generator=g, device=device, dtype=dtype)
    grad = torch.randn((M, 3), generator=g, device=device, dtype=dtype)
    return T, idx, pts, grad


def _grads(fn, T, idx, pts, grad, pts_grad=True):
    """(xc, grad of T, grad of pts or None) of ``fn`` with ``grad`` on xc."""
    T = T.detach().clone().requires_grad_()
    p = pts.detach().clone().requires_grad_(pts_grad)
    xc = fn(T, idx, p)
    xc.backward(grad)
    return xc.detach(), T.grad, p.grad


# -- CPU ---------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """(a) ``nearest_warp`` on CPU tensors is ``nearest_warp_ref``: the
    gather's values and gradients bit for bit, and nothing is built."""
    calls = []
    real = knn.nearest_warp_ref

    def spy(T_inv, idx, pts):
        calls.append(pts.shape[0])
        return real(T_inv, idx, pts)
    monkeypatch.setattr(knn, "nearest_warp_ref", spy)
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    T, idx, pts, grad = _inputs(500, 40, 0)
    got = _grads(knn.nearest_warp, T, idx, pts, grad)
    want = _grads(_old_warp, T, idx, pts, grad)
    assert calls == [500]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_deform_is_the_gather_on_cpu(monkeypatch):
    """(a) ``SMPLDeformer.deform`` on the CPU gives the canonical points,
    validity and gradients (SMPL leaves and points) that the inline gather
    gave, bit for bit (on one thread: the SMPL leaves' gradients through
    ``prepare`` vary in the last bits from run to run across threads)."""
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _deform_both_ways()
    finally:
        torch.set_num_threads(threads)


def _deform_both_ways():
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SMPLDeformer
    body = toy_smpl_model(device=torch.device("cpu"))
    deformer = SMPLDeformer(body)
    g = torch.Generator().manual_seed(2)
    leaves = [torch.zeros((1, 10)), 0.2 * torch.randn((1, 69), generator=g),
              0.1 * torch.randn((1, 3), generator=g),
              torch.tensor([[0.0, 0.1, 0.2]])]
    pts0 = 0.5 * torch.randn((3000, 3), generator=g)
    weight = torch.randn((3000, 3), generator=g)
    out = []
    for new in (True, False):
        ls = [t.clone().requires_grad_() for t in leaves]
        pts = pts0.clone().requires_grad_()
        frame = deformer.prepare(deformer.build_canonical(ls[0]), *ls)
        if new:
            xc, valid = deformer.deform(frame, pts)
        else:
            d2, idx = knn.nearest_vertex(pts.detach(),
                                         frame.verts_smpl.detach())
            xc = _old_warp(frame.T_inv, idx, pts)
            valid = d2 < deformer.threshold ** 2
        (xc * weight).sum().backward()
        out.append([xc.detach(), valid, pts.grad, *(t.grad for t in ls)])
    assert 0 < int(out[0][1].sum()) < 3000
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pts_grad", [True, False])
def test_kernel_arithmetic_is_autograd_of_the_plain_version(pts_grad):
    """(b) What the kernels compute, written in PyTorch in float64, is
    autograd's gradient through the plain version: grad_T[v, r, :3] = sum
    of grad_xc[r] * p, grad_T[v, r, 3] = sum of grad_xc[r] over the
    samples of v, row 3 zero; grad_pts = R^T grad_xc (when asked for).
    Samples come in runs of one vertex, as a ray's do."""
    T, _, pts, grad = _inputs(640, 12, 1, torch.float64)
    idx = torch.randint(0, 12, (10,), generator=torch.Generator()
                        .manual_seed(3)).repeat_interleave(64)
    grad[::3] = 0.0   # the samples outside the threshold
    xc, gT, gp = _grads(knn.nearest_warp_ref, T, idx, pts, grad, pts_grad)
    R, t = T[idx, :3, :3], T[idx, :3, 3]
    rows = torch.cat([grad[:, :, None] * pts[:, None, :],
                      grad[:, :, None]], dim=-1)              # (M, 3, 4)
    want_T = torch.zeros_like(T)
    want_T[:, :3].index_add_(0, idx, rows)
    torch.testing.assert_close(xc, (R @ pts[..., None])[..., 0] + t,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gT, want_T, rtol=1e-12, atol=1e-12)
    assert not gT[:, 3].any()
    if pts_grad:
        torch.testing.assert_close(
            gp, (R.transpose(1, 2) @ grad[..., None])[..., 0],
            rtol=1e-12, atol=1e-12)
    else:
        assert gp is None


def _bad(kind: str):
    meta = torch.device("meta")
    T = torch.empty((7, 4, 4), device=meta)
    idx = torch.empty((10,), dtype=torch.int64, device=meta)
    pts = torch.empty((10, 3), device=meta)
    if kind == "T_dtype":
        return T.double(), idx, pts, TypeError
    if kind == "idx_dtype":
        return T, idx.int(), pts, TypeError
    if kind == "pts_dtype":
        return T, idx, pts.half(), TypeError
    if kind == "T_shape":
        return torch.empty((7, 3, 4), device=meta), idx, pts, ValueError
    if kind == "pts_shape":
        return T, idx, torch.empty((10, 4), device=meta), ValueError
    if kind == "idx_shape":
        return T, idx[:9], pts, ValueError
    if kind == "T_non_contiguous":
        return T.transpose(1, 2), idx, pts, ValueError
    if kind == "idx_non_contiguous":
        return T, torch.empty((20,), dtype=torch.int64, device=meta)[::2], \
            pts, ValueError
    if kind == "pts_non_contiguous":
        return T, idx, torch.empty((3, 10), device=meta).T, ValueError
    if kind == "misaligned":
        return torch.zeros((7 * 16 + 1,))[1:].view(7, 4, 4), \
            torch.zeros((10,), dtype=torch.int64), torch.zeros((10, 3)), \
            ValueError
    if kind == "cpu":
        return torch.zeros((7, 4, 4)), torch.zeros((10,), dtype=torch.int64), \
            torch.zeros((10, 3)), ValueError
    if kind == "mixed":
        return torch.zeros((7, 4, 4)), idx, pts, ValueError
    return T, idx, pts, ValueError     # "meta": right in all but the device


@pytest.mark.parametrize("kind", [
    "T_dtype", "idx_dtype", "pts_dtype", "T_shape", "pts_shape",
    "idx_shape", "T_non_contiguous", "idx_non_contiguous",
    "pts_non_contiguous", "misaligned", "cpu", "mixed", "meta"])
def test_warp_wrapper_checks_raise_before_build(monkeypatch, kind):
    """(c) The wrapper's checks (dtypes, shapes, contiguity, alignment,
    the device) raise before anything is built; ``nearest_warp`` sends
    any tensor off the CPU to the wrapper, which raises: nothing falls
    back."""
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    T, idx, pts, err = _bad(kind)
    with pytest.raises(err):
        nearest_warp_cuda(T, idx, pts)
    if kind in ("meta", "mixed"):
        with pytest.raises(ValueError, match="one CUDA device"):
            knn.nearest_warp(T, idx, pts)


@pytest.mark.parametrize("deterministic", [False, True])
def test_empty_warp_launches_nothing(monkeypatch, deterministic):
    """(d) M = 0: an empty (0, 3) forward, a zero table gradient and an
    empty points' gradient, no build and no launch counted (the checks
    stubbed so that CPU tensors pass them)."""
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    monkeypatch.setattr(kernel_mod, "_check_warp", lambda *a: None)
    before = (nearest_warp_cuda.launches, nearest_warp_cuda.rows)
    T, idx, pts, grad = _inputs(0, 5, 4)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        xc, gT, gp = _grads(nearest_warp_cuda, T, idx, pts, grad)
    finally:
        torch.use_deterministic_algorithms(was)
    assert xc.shape == (0, 3) and gp.shape == (0, 3)
    assert gT.shape == (5, 4, 4) and not gT.any()
    assert (nearest_warp_cuda.launches, nearest_warp_cuda.rows) == before


# -- the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _exact(T, idx, pts, grad):
    """The gradients in float64 (every product of two fp32 exact)."""
    T, pts, grad = T.double(), pts.double(), grad.double()
    rows = torch.cat([grad[:, :, None] * pts[:, None, :], grad[:, :, None]],
                     dim=-1)
    gT = torch.zeros_like(T)
    gT[:, :3].index_add_(0, idx, rows)
    return gT, (T[idx, :3, :3].transpose(1, 2) @ grad[..., None])[..., 0]


def _deterministic(T, idx, pts, grad, pts_grad):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _grads(nearest_warp_cuda, T, idx, pts, grad, pts_grad)
    finally:
        torch.use_deterministic_algorithms(was)


def _same(T, idx, pts, grad):
    """Kernels against the plain version, with and without the points'
    gradient, and the deterministic path twice.

    - xc within 1e-6 of the plain version, and bit-equal to it from 100
      samples up (cuBLAS's order for the batched matmul, probed on the
      card; the fit's pose gradient sees the last bit of xc).
    - The table's gradient: the atomics add the warps' sums in another
      order than the plain version's sequential sum over the sorted
      samples, so the two differ by about the sequential sum's own
      rounding. Held L2-relative within 1e-5 of the plain version, or,
      where the plain version's own gap to the float64 sum is wider (a
      vertex with ~10^5 terms), within 3 times that gap.
    - The points' gradient (three products a sample, no sum across
      samples) L2-relative within 1e-5.
    - The deterministic path: the same bits twice, held as the atomic
      path is, and bit-equal to the plain version's sorted sums."""
    exact_T, exact_p = _exact(T, idx, pts, grad)
    for pts_grad in (True, False):
        want = _grads(knn.nearest_warp_ref, T, idx, pts, grad, pts_grad)
        tol_T = max(1e-5, 3 * _rel(want[1], exact_T))
        runs = [_grads(nearest_warp_cuda, T, idx, pts, grad, pts_grad),
                _deterministic(T, idx, pts, grad, pts_grad),
                _deterministic(T, idx, pts, grad, pts_grad)]
        for xc, gT, gp in runs:
            assert float((xc - want[0]).abs().max()) <= 1e-6
            assert pts.shape[0] < 100 or torch.equal(xc, want[0])
            assert _rel(gT, want[1]) <= tol_T, (_rel(gT, want[1]), tol_T)
            assert _rel(gT, exact_T) <= tol_T
            assert not gT[:, 3].any()
            if pts_grad:
                assert _rel(gp, want[2]) <= 1e-5
                assert _rel(gp, exact_p) <= 1e-5
            else:
                assert gp is None
        for a, b in zip(runs[1], runs[2]):
            assert a is b is None or torch.equal(a, b)
        assert torch.equal(runs[1][1], want[1])


def _fit_step_inputs(cuda):
    """The fit's own step at its size (``chip_smoke.fit_step_model``: the
    demo's ``SNARF_NGP_fitting`` conf with ``deformer=smpl`` as
    ``config/build.py`` builds it, on the 7,008-vertex toy body, 4 x 32^2
    patch rays of 540 px capsule frames): one eager step's warp of the
    rays' samples (the call whose points carry a gradient; an update
    step's grid sweep warps 64^3 cells too) and the gradient reaching xc;
    then 2 captured steps and 3 replays, over which the warp's counters
    count a forward and a backward launch of every nearest-vertex
    search's 262,144 rows."""
    from chip_smoke import fit_step_model, fit_warp_call
    model, state, steps = fit_step_model(cuda)
    state, rec = fit_warp_call(model, state, *steps(0, 1))
    M = rec[2].shape[0]
    assert M == 262144 and rec[0].shape == (7008, 4, 4)
    state, _ = model.train_multi_step(state, *steps(1, 2))   # captures
    before = [(k.launches, k.rows) for k in (nearest_warp_cuda,
                                             nearest_vertex_cuda)]
    state, _ = model.train_multi_step(state, *steps(3, 3))   # replays
    torch.cuda.synchronize(cuda)
    (warp, wrows), (knn_n, knn_rows) = [
        (k.launches - b[0], k.rows - b[1])
        for k, b in zip((nearest_warp_cuda, nearest_vertex_cuda), before)]
    assert knn_n >= 3 and knn_rows == knn_n * M
    assert (warp, wrows) == (2 * knn_n, 2 * knn_n * M)
    zero = ~rec[3].ne(0).any(-1)
    assert 0 < int(zero.sum()) < M   # samples inside and outside
    return rec


def _case_fit_step(cuda):
    _same(*_fit_step_inputs(cuda))


def _case_one_vertex(cuda):
    T, idx, pts, grad = _inputs(262144, 7008, 5, device=cuda)
    _same(T, torch.full_like(idx, 4321), pts, grad)


def _case_random(cuda):
    _same(*_inputs(262144, 7008, 6, device=cuda))


def _case_mostly_zero(cuda):
    """Rays of 64 samples over a few vertices each, 90% of the rows'
    gradients exactly zero (the samples outside the threshold)."""
    T, _, pts, grad = _inputs(262144, 7008, 7, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    idx = torch.randint(0, 7008, (262144 // 16,), generator=g,
                        device=cuda).repeat_interleave(16)
    grad[torch.rand((262144,), generator=g, device=cuda) < 0.9] = 0.0
    _same(T, idx, pts, grad)


def _case_ragged(cuda):
    """M = 1, a part warp, a part block, past a block; and indices
    outside [0, V): NaN points and no gradient."""
    for M in (1, 31, 33, 262144 + 37):
        _same(*_inputs(M, 7008, M, device=cuda))
    T, idx, pts, grad = _inputs(1000, 50, 9, device=cuda)
    idx[3], idx[700] = -1, 50
    xc, gT, gp = _grads(nearest_warp_cuda, T, idx, pts, grad)
    bad = torch.zeros(1000, dtype=torch.bool, device=cuda)
    bad[[3, 700]] = True
    assert bool(xc[bad].isnan().all()) and bool(gp[bad].isnan().all())
    keep = ~bad
    want = _grads(knn.nearest_warp_ref, T, idx[keep], pts[keep], grad[keep])
    assert float((xc[keep] - want[0]).abs().max()) <= 1e-6
    assert _rel(gT, want[1]) <= 1e-5


def _case_graph(cuda):
    """Forward and backward captured in a CUDA graph replay to the eager
    results: the forward and the deterministic backward bit for bit, the
    atomic backward as ``_same`` holds it. The capture makes its own
    leaves (copies of the inputs), as a captured step does."""
    T, idx, pts, grad = _inputs(262144, 7008, 10, device=cuda)

    def call():
        Tl = T.clone().requires_grad_()
        pl = pts.clone().requires_grad_()
        xc = nearest_warp_cuda(Tl, idx, pl)
        return [t.detach() for t in (
            xc, *torch.autograd.grad(xc, (Tl, pl), grad))]
    for deterministic in (False, True):
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(deterministic)
        try:
            eager = call()    # the warm-up, outside the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize(cuda)
                assert torch.equal(out[0], eager[0])
                assert torch.equal(out[2], eager[2])
                if deterministic:
                    assert torch.equal(out[1], eager[1])
                else:
                    assert _rel(out[1], eager[1]) <= 1e-5
        finally:
            torch.use_deterministic_algorithms(was)


CASES = {"fit_step": _case_fit_step, "one_vertex": _case_one_vertex,
         "random": _case_random, "mostly_zero": _case_mostly_zero,
         "ragged": _case_ragged, "graph": _case_graph}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_warp_kernels_match_plain_on_card(cuda, case):
    """The cases above, one each."""
    CASES[case](cuda)
