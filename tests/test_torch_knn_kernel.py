"""The nearest-vertex kernel (``csrc/nearest_vertex.cu``) against the plain
chunked version ``ops.knn.nearest_vertex_ref``.

On the card (marker ``cuda``; they skip without one), one parametrised
test, each case the kernel beside the plain version on the same card:

(a) d^2 bit-equal and the index equal on the 64^3 shell cells of 30
    poses of a looping motion against the 7,008-vertex toy body, and on
    random points against 192 and 6,890 vertices;
(b) on those poses, ``_shell_grid``'s occupancy identical;
(c) exact ties resolve to the first index, also where the tied vertices
    lie in two shared-memory tiles, for points in many warps and blocks;
(d) M = 0, M = 1, M not a multiple of a block's 1,024 points, V above
    one tile, and NaN and infinite inputs;
(the plain version on the points padded to whole chunks, as ``_same``
says why;)
(e) under CUDA-graph capture, the kernel's replays bit-equal to eager
    calls, and through ``GridGraphs`` the grid equal to the eager build
    and the counters added once per replay.

On the CPU: CUDA-less tensors run the plain version and never build the
kernel; the plain version finds the exact nearest vertex, the first on
a tie; the wrapper's checks raise before anything is built. This file
imports no jax:

    python -m pytest tests/test_torch_knn_kernel.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from instantavatar_torch.kernels import nearest_vertex as kernel_mod
from instantavatar_torch.kernels.nearest_vertex import nearest_vertex_cuda
from instantavatar_torch.ops import knn

N_POSES = 30
# a looping motion, [pose entry, amplitude, period in frames, phase] each
# (the benchmark's animate motion): arms, legs, spine and a slow drift
MOTION = [[47, 0.5, 40.0, 0.0], [50, -0.5, 40.0, 0.0],
          [52, 0.6, 30.0, 1.0], [55, -0.6, 60.0, 2.0],
          [0, 0.4, 24.0, 0.5], [3, -0.4, 24.0, 0.5],
          [9, 0.5, 40.0, 1.5], [12, 0.5, 120.0, 3.0],
          [46, 0.05, 1000000.0, 0.0]]


def _no_build():
    raise AssertionError("the kernel library was built")


# -- CPU ---------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """``nearest_vertex`` on CPU tensors is ``nearest_vertex_ref`` at its
    own chunk, the same values, and the kernel is never built."""
    calls = []
    real = knn.nearest_vertex_ref

    def spy(pts, verts, chunk=8192):
        calls.append((pts.shape[0], chunk))
        return real(pts, verts, chunk)
    monkeypatch.setattr(knn, "nearest_vertex_ref", spy)
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    g = np.random.default_rng(0)
    pts = torch.as_tensor(g.standard_normal((300, 3)), dtype=torch.float32)
    verts = torch.as_tensor(g.standard_normal((50, 3)), dtype=torch.float32)
    d2, idx = knn.nearest_vertex(pts, verts)
    assert calls == [(300, 8192)]
    want_d2, want_idx = real(pts, verts)
    assert torch.equal(d2, want_d2) and torch.equal(idx, want_idx)
    assert idx.dtype == torch.int64


@pytest.mark.parametrize("case", ["empty", "one_point", "ragged",
                                  "two_chunks_and_one", "one_vertex",
                                  "lattice_ties"])
def test_cpu_plain_version_is_the_exact_nearest_vertex(case):
    """On the CPU, ``nearest_vertex`` (the plain version, in chunks of
    8,192 points) finds each point's nearest vertex: M = 0, M = 1, M past
    one and two chunks and not a multiple of one, a single vertex, and
    integer lattice points, where every distance is exact and an exact
    tie goes to the first index."""
    g = torch.Generator().manual_seed(3)
    if case == "lattice_ties":
        verts = torch.randint(-3, 4, (400, 3), generator=g).float()
        pts = torch.randint(-5, 6, (2000, 3), generator=g).float()
    else:
        M, V = {"empty": (0, 50), "one_point": (1, 50),
                "ragged": (8192 + 37, 64), "two_chunks_and_one": (16385, 64),
                "one_vertex": (300, 1)}[case]
        verts = torch.randn((V, 3), generator=g)
        pts = torch.randn((M, 3), generator=g)
    d2, idx = knn.nearest_vertex(pts, verts)
    assert d2.shape == idx.shape == (pts.shape[0],)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int64
    if not pts.shape[0]:
        return
    full = ((pts[:, None, :].double() - verts[None].double()) ** 2).sum(-1)
    nearest = full.min(1).values
    picked = full.gather(1, idx[:, None])[:, 0]
    if case == "lattice_ties":
        first = (full == nearest[:, None]).double().argmax(1)
        assert torch.equal(idx, first)
        assert torch.equal(d2.double(), nearest)
        assert int((full == nearest[:, None]).sum(1).gt(1).sum()) > 100
    else:
        torch.testing.assert_close(picked, nearest, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d2.double(), picked, rtol=1e-5,
                                   atol=1e-5)


def _bad(kind: str):
    meta = torch.device("meta")
    pts, verts = torch.empty((10, 3), device=meta), \
        torch.empty((7, 3), device=meta)
    if kind == "dtype":
        return pts.double(), verts, TypeError
    if kind == "pts_shape":
        return torch.empty((10, 2), device=meta), verts, ValueError
    if kind == "verts_shape":
        return pts, torch.empty((7, 4), device=meta), ValueError
    if kind == "non_contiguous":
        return torch.empty((3, 10), device=meta).T, verts, ValueError
    if kind == "cpu":
        return torch.zeros((10, 3)), torch.zeros((7, 3)), ValueError
    return pts, verts, ValueError      # "meta": right in all but the device


@pytest.mark.parametrize("kind", ["dtype", "pts_shape", "verts_shape",
                                  "non_contiguous", "cpu", "meta"])
def test_kernel_wrapper_checks_raise_before_build(monkeypatch, kind):
    """The wrapper's checks (dtype, shapes, contiguity, the device) raise
    before anything is built; ``nearest_vertex`` sends any tensor off the
    CPU to the wrapper, which raises: nothing falls back."""
    monkeypatch.setattr(kernel_mod, "build_knn_library", _no_build)
    pts, verts, err = _bad(kind)
    with pytest.raises(err):
        nearest_vertex_cuda(pts, verts)
    if kind == "meta":
        with pytest.raises(ValueError, match="one CUDA device"):
            knn.nearest_vertex(pts, verts)


# -- the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(pts, verts, chunk=8192):
    """Kernel vs plain on the card: d^2 bit for bit, the index equal. The
    plain version runs on the points padded to whole chunks: cuBLAS rounds
    a chunk of a few rows' x.v otherwise (ops/knn.py), and the kernel
    holds a whole chunk's rounding at every M."""
    M = pts.shape[0]
    padded = torch.cat([pts, pts.new_zeros(((-M) % chunk, 3))])
    d0, i0 = (t[:M] for t in knn.nearest_vertex_ref(padded, verts, chunk))
    d1, i1 = nearest_vertex_cuda(pts.contiguous(), verts.contiguous())
    assert d1.dtype == torch.float32 and i1.dtype == torch.int64
    assert torch.equal(_bits(d0), _bits(d1)), \
        f"{int((_bits(d0) != _bits(d1)).sum())} of {len(d0)} d^2 differ"
    assert torch.equal(i0, i1), f"{int((i0 != i1).sum())} indices differ"
    return d1, i1


def _animate(device):
    """The 7,008-vertex toy body (ring_size 16, bone_rings 18) under
    Fast-SNARF (res 128) in a model whose per-pose grid is the 64^3 body
    shell (margin 0.08), on ``device``, and the batches of ``MOTION``'s
    frames 0 to N_POSES - 1, 5 m from the camera."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import VoxelTriplaneField
    from instantavatar_torch.train import AvatarModel
    body = toy_smpl_model(ring_size=16, bone_rings=18, device=device)
    deformer = SNARFDeformer(body, resolution=128, n_iters=6,
                             n_init_active=4, cand_cap=2)
    model = AvatarModel(body, VoxelTriplaneField(voxel_res=4, plane_res=8,
                                                 device=device),
                        deformer, grid_size=64, eval_grid="smpl_shell",
                        shell_margin=0.08)
    state = model.init(np.zeros((1, 10), np.float32))
    t = np.arange(N_POSES, dtype=np.float64)
    poses = np.zeros((N_POSES, 69), np.float32)
    for index, amp, period, phase in MOTION:
        poses[:, index] += amp * np.sin(2 * np.pi * t / period + phase)
    return model, state, [
        {"betas": np.zeros(10, np.float32), "body_pose": pose,
         "global_orient": np.zeros(3, np.float32),
         "transl": np.array([0.0, 0.15, 5.0], np.float32),
         "idx": np.int32(0)} for pose in poses]


def _case_animate(cuda):
    """(a), (b): every shell cell of every pose, and the occupancy."""
    from instantavatar_torch.train import model as model_mod
    model, state, batches = _animate(cuda)
    seen = []

    def both(cells, verts):
        seen.append(cells.shape[0])
        return _same(cells, verts)
    for batch in batches:
        grids = []
        for fn in (both, knn.nearest_vertex_ref):
            model_mod.nearest_vertex, real = fn, model_mod.nearest_vertex
            try:
                grids.append(model.build_pose_grid(state, batch, graph=False))
            finally:
                model_mod.nearest_vertex = real
        assert torch.equal(grids[0].occupancy, grids[1].occupancy)
        assert 0 < int(grids[0].occupancy.sum()) < 64 ** 3
    assert seen == [64 ** 3] * N_POSES


def _case_random(cuda, V):
    """(a): random points around random vertices (the SMPL deformer's
    spread), in chunks of 8,192 and of 2,048 in the plain version."""
    g = torch.Generator(device=cuda).manual_seed(V)
    verts = torch.randn((V, 3), device=cuda, generator=g) * 0.4
    pts = torch.cat([
        verts[torch.randint(0, V, (40000,), device=cuda, generator=g)]
        + 0.03 * torch.randn((40000, 3), device=cuda, generator=g),
        torch.randn((30000, 3), device=cuda, generator=g) * 0.6])
    _same(pts, verts)
    _same(pts, verts, chunk=2048)


def _case_ties(cuda):
    """(c): integer lattice points, where every distance is exact and
    many tie, with V = 10,000 vertices drawn with repeats, so tied
    vertices lie in both tiles of 7,168; the index is the first minimum."""
    g = torch.Generator(device=cuda).manual_seed(11)
    verts = torch.randint(-3, 4, (10000, 3), device=cuda,
                          generator=g).float()
    pts = torch.randint(-5, 6, (20000, 3), device=cuda, generator=g).float()
    pts[:1000] = 0.5   # every vertex of a lattice cube's corner ties
    d2, idx = _same(pts, verts)
    full = ((pts[:, None, :] - verts[None]) ** 2).sum(-1)   # exact here
    first = (full == full.min(1, keepdim=True).values).float().argmax(1)
    assert torch.equal(idx, first)
    assert int((full == d2[:, None]).sum(1).gt(1).sum()) > 10000
    # a tie whose first vertex is in the second tile
    far = torch.full((9000, 3), 50.0, device=cuda)
    far[7500] = far[8000] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    far[8500] = torch.tensor([0.0, -1.0, 0.0], device=cuda)
    _, idx = _same(torch.zeros((3000, 3), device=cuda), far)
    assert bool((idx == 7500).all())


def _case_shapes(cuda):
    """(d): M = 0, M = 1, ragged M (not a multiple of a block's 1,024
    points), V above one tile, and NaN and infinite inputs (a NaN is the
    least distance, the first NaN wins)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    verts = torch.randn((7008, 3), device=cuda, generator=g)
    big = torch.randn((20000, 3), device=cuda, generator=g)
    for M in (0, 1, 37, 8193, 262144 + 37):
        _same(torch.randn((M, 3), device=cuda, generator=g), verts)
    _same(torch.randn((5000, 3), device=cuda, generator=g), big)
    pts = torch.randn((3000, 3), device=cuda, generator=g)
    pts[10, 1], pts[20, 0], pts[30, 2] = float("nan"), float("inf"), 1e30
    _same(pts, verts)
    bad = big.clone()   # NaNs in both tiles: the first wins
    bad[7300, 2], bad[9000, 0] = float("nan"), float("nan")
    _same(torch.randn((3000, 3), device=cuda, generator=g), bad)
    bad[100, 1] = float("nan")
    _same(torch.randn((3000, 3), device=cuda, generator=g), bad)


def _case_graph(cuda):
    """(e): the kernel captured in a graph replays bit-equal to eager
    calls; the shell grid through ``GridGraphs`` equals the eager build,
    and each replay adds one launch of 64^3 rows to the counters."""
    g = torch.Generator(device=cuda).manual_seed(5)
    verts = torch.randn((7008, 3), device=cuda, generator=g)
    static = torch.randn((100000, 3), device=cuda, generator=g)
    nearest_vertex_cuda(static, verts)       # warm-up, outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nearest_vertex_cuda(static, verts)
    for _ in range(3):
        static.copy_(torch.randn((100000, 3), device=cuda, generator=g))
        graph.replay()
        d0, i0 = nearest_vertex_cuda(static, verts)
        assert torch.equal(_bits(out[0]), _bits(d0))
        assert torch.equal(out[1], i0)
    model, state, batches = _animate(cuda)
    model.build_pose_grid(state, batches[0])       # the capture
    before = (nearest_vertex_cuda.launches, nearest_vertex_cuda.rows)
    grids = [model.build_pose_grid(state, b) for b in batches[1:4]]
    assert (nearest_vertex_cuda.launches - before[0],
            nearest_vertex_cuda.rows - before[1]) == (3, 3 * 64 ** 3)
    for b, grid in zip(batches[1:4], grids):
        eager = model.build_pose_grid(state, b, graph=False)
        assert torch.equal(grid.occupancy, eager.occupancy)
        assert torch.equal(grid.density_cached, eager.density_cached)


CASES = {"animate_poses": _case_animate,
         "random_192": lambda d: _case_random(d, 192),
         "random_6890": lambda d: _case_random(d, 6890),
         "ties": _case_ties, "shapes": _case_shapes, "graph": _case_graph}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    """(a)-(e) above, one case each."""
    CASES[case](cuda)
