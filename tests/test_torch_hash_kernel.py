"""The hash-encode kernel's CPU-side contract (``csrc/hash_encode.cu``
runs only on the card; ``tests/test_torch_cuda.py`` holds it there):

(a) its closed-form backward in plain torch, ``hash_encode_backward_ref``,
    against ``jax.grad`` of JAX's ``hash_encode``, 1e-5 L2-relative (the
    table's and the points' gradient, the 0.5 clip gradient at exactly 0
    and 1 included), at the default grid and at a small grid with dense
    and hashed levels; and at the small grid with F = 1, 2, 3, 4 and 8
    features per row, ``hash_encode_ref`` against JAX's ``hash_encode``
    (1e-6) and the backward against ``jax.grad`` (1e-5);
(b) the deterministic backward's plan (rows sorted stably, the sorted
    entries cut into chunks of 32, each run's piece in a chunk summed in
    point order, then a run's pieces in chunk order), modelled here in
    plain torch, against ``index_add_``, 1e-6 L2-relative, and
    bit-identical to itself on two runs;
(c) dispatch: a CPU tensor runs ``hash_encode_ref``; the kernel wrapper's
    argument checks raise before anything is built, and pass any F >= 1
    and up to 64 levels with L * T < 2^31; nothing falls back;
(d) the graph modules' shared counter helper.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.ops import hashgrid as jax_hashgrid
from instantavatar_torch.kernels import counters
from instantavatar_torch.kernels import hash_encode as kernel_mod
from instantavatar_torch.ops import hashgrid
from instantavatar_torch.ops.hashgrid import (HashGridConfig, hash_encode,
                                              hash_encode_backward_ref,
                                              hash_encode_ref,
                                              level_resolutions)
from instantavatar_torch.train import frame_graph, grid_graph, step_graph

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

# level 0 dense (9^3 <= 2^12), levels 1-3 hashed
SMALL = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8,
             per_level_scale=2.0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _points(n: int, cfg: HashGridConfig, seed: int) -> np.ndarray:
    """Uniform in [-0.1, 1.1]^3, with rows at exactly 0 and 1, on lattice
    points of every level, and partly outside [0, 1]."""
    g = np.random.default_rng(seed)
    x = g.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[:8], x[8:16] = 0.0, 1.0
    x[16:24, 0], x[24:32, 1] = 0.0, 1.0          # one axis on the boundary
    for i, r in enumerate(level_resolutions(cfg)):
        x[32 + 16 * i:48 + 16 * i] = g.integers(0, r + 1, (16, 3)) / r
    return x


def _inputs(cfg: HashGridConfig, n: int, seed: int):
    g = np.random.default_rng(seed)
    x = _points(n, cfg, seed)
    table = g.normal(0.0, 0.1, (cfg.n_levels, cfg.table_size,
                                cfg.n_features)).astype(np.float32)
    ct = g.normal(size=(n, cfg.out_dim)).astype(np.float32)
    return table, x, ct


@pytest.mark.parametrize("grid,n", [("default", 1024), ("small", 2048)])
def test_backward_ref_matches_jax_grad(grid, n):
    """(a) ``hash_encode_backward_ref`` against ``jax.grad`` of JAX's
    ``hash_encode`` (a random projection of the features), 1e-5
    L2-relative for the table and for the points; the points exactly on
    0 or 1 get JAX's half gradient on that axis."""
    kw = SMALL if grid == "small" else {}
    cfg = HashGridConfig(**kw)
    jcfg = jax_hashgrid.HashGridConfig(**kw)
    if grid == "small":
        dense = [(r + 1) ** 3 <= cfg.table_size
                 for r in level_resolutions(cfg)]
        assert any(dense) and not all(dense)
    table, x, ct = _inputs(cfg, n, seed=5)

    def jf(tab, xx):
        return jnp.sum(jax_hashgrid.hash_encode(tab, xx, jcfg) * ct)
    jg_tab, jg_x = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(table),
                                                         jnp.asarray(x))
    g_tab, g_x = hash_encode_backward_ref(
        torch.as_tensor(table), torch.as_tensor(x), torch.as_tensor(ct), cfg)
    assert _rel(g_tab.numpy(), jg_tab) <= 1e-5
    assert _rel(g_x.numpy(), jg_x) <= 1e-5
    # the boundary rows alone: the 0.5 clip gradient (and 0 outside)
    edge = slice(0, 32)
    assert _rel(g_x.numpy()[edge], np.asarray(jg_x)[edge]) <= 1e-5
    assert np.abs(np.asarray(jg_x)[edge]).max() > 0


@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_feature_widths_match_jax(F):
    """(a) At the small grid with F features per row (every width the
    kernel compiles, and 3, which its feature loop takes):
    ``hash_encode_ref`` against JAX's ``hash_encode``, features within
    1e-6, and ``hash_encode_backward_ref`` against ``jax.grad`` of it, the
    table's and the points' gradients within 1e-5 L2-relative."""
    kw = dict(SMALL, n_features=F)
    cfg = HashGridConfig(**kw)
    jcfg = jax_hashgrid.HashGridConfig(**kw)
    table, x, ct = _inputs(cfg, 1024, seed=F)
    feats = hash_encode_ref(torch.as_tensor(table), torch.as_tensor(x), cfg)
    jfeats = jax_hashgrid.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                      jcfg)
    assert feats.shape == (1024, 4 * F)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=1e-6)

    def jf(tab, xx):
        return jnp.sum(jax_hashgrid.hash_encode(tab, xx, jcfg) * ct)
    jg_tab, jg_x = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(table),
                                                         jnp.asarray(x))
    g_tab, g_x = hash_encode_backward_ref(
        torch.as_tensor(table), torch.as_tensor(x), torch.as_tensor(ct), cfg)
    assert _rel(g_tab.numpy(), jg_tab) <= 1e-5
    assert _rel(g_x.numpy(), jg_x) <= 1e-5


def test_backward_ref_matches_autograd_of_ref():
    """The closed form agrees with autograd through the plain version."""
    cfg = HashGridConfig(**SMALL)
    table, x, ct = _inputs(cfg, 1024, seed=6)
    tt = torch.as_tensor(table).requires_grad_()
    xt = torch.as_tensor(x).requires_grad_()
    (hash_encode_ref(tt, xt, cfg) * torch.as_tensor(ct)).sum().backward()
    g_tab, g_x = hash_encode_backward_ref(
        torch.as_tensor(table), torch.as_tensor(x), torch.as_tensor(ct), cfg)
    assert _rel(g_tab.numpy(), tt.grad.numpy()) <= 1e-6
    assert _rel(g_x.numpy(), xt.grad.numpy()) <= 1e-5


def _kernel_plan_sum(rows: torch.Tensor, contrib: torch.Tensor,
                     n_rows: int, chunk: int = 32) -> torch.Tensor:
    """``encode_run_pieces`` and ``encode_run_join``'s order in plain
    torch: entries' rows (E,) sorted stably (point order within a row),
    the sorted list cut into chunks of ``chunk``; each run's piece in a
    chunk summed from zero in entry order, then each run's pieces summed
    in chunk order; each row written once -> (n_rows, F). Every
    accumulation below adds at most one value per target, in order."""
    srt, perm = torch.sort(rows, stable=True)
    c = contrib[perm]
    k = torch.arange(srt.numel())
    new_run = torch.ones_like(srt, dtype=torch.bool)
    new_run[1:] = srt[1:] != srt[:-1]
    new_piece = new_run | (k % chunk == 0)
    piece = torch.cumsum(new_piece.long(), 0) - 1
    pos = k - torch.nonzero(new_piece).squeeze(1)[piece]
    pieces = c.new_zeros((int(piece[-1]) + 1, c.shape[1]))
    for j in range(chunk):
        m = pos == j
        pieces[piece[m]] += c[m]
    piece_row = srt[new_piece]
    run_start = torch.ones_like(piece_row, dtype=torch.bool)
    run_start[1:] = piece_row[1:] != piece_row[:-1]
    run = torch.cumsum(run_start.long(), 0) - 1
    rank = torch.arange(piece_row.numel()) - torch.nonzero(
        run_start).squeeze(1)[run]
    runs = c.new_zeros((int(run[-1]) + 1, c.shape[1]))
    for j in range(int(rank.max()) + 1):
        m = rank == j
        runs[run[m]] += pieces[m]
    out = c.new_zeros((n_rows, c.shape[1]))
    out[piece_row[run_start]] = runs
    return out


def test_sorted_run_sum_plan():
    """(b) The deterministic kernel's plan (``_kernel_plan_sum``, entries
    of a (point, level) whose gradient is zero left out, as the kernel
    leaves them out) against ``index_add_``, 1e-6 L2-relative, and
    bit-identical on two runs; points crowd a few coarse cells, so rows
    repeat thousands of times and runs cross many chunks, as at the
    default grid."""
    cfg = HashGridConfig(**SMALL)
    table, x, ct = _inputs(cfg, 4096, seed=7)
    x[2048:] = 0.5 + 0.01 * x[2048:]              # half in a few cells
    ct[::7] = 0.0                                 # skipped entries
    consts = hashgrid._level_constants(cfg, level_resolutions(cfg), "cpu")
    slots, w, _ = hashgrid._slots_weights(torch.as_tensor(x), cfg, consts)
    g = torch.as_tensor(ct).reshape(-1, cfg.n_levels, 1, cfg.n_features)
    contrib = (w[..., None] * g).reshape(-1, cfg.n_features)
    keep = (g != 0).any(-1).expand_as(w).reshape(-1)
    rows = slots.reshape(-1).long()
    n_rows = cfg.n_levels * cfg.table_size
    ref, _ = hash_encode_backward_ref(torch.as_tensor(table),
                                      torch.as_tensor(x),
                                      torch.as_tensor(ct), cfg)
    one, two = (_kernel_plan_sum(rows[keep], contrib[keep], n_rows)
                for _ in range(2))
    assert int(torch.unique(rows, return_counts=True)[1].max()) > 32 * 32
    assert _rel(one.numpy(), ref.reshape(n_rows, -1).numpy()) <= 1e-6
    assert torch.equal(one, two)


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """(c) ``hash_encode`` on CPU tensors is ``hash_encode_ref``, the
    same values, with the kernel library never built."""
    calls = []
    real = hashgrid.hash_encode_ref

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    def no_build():
        raise AssertionError("the kernel library was built for CPU tensors")
    monkeypatch.setattr(hashgrid, "hash_encode_ref", spy)
    monkeypatch.setattr(kernel_mod, "build_hash_library", no_build)
    cfg = HashGridConfig(**SMALL)
    table, x, _ = _inputs(cfg, 256, seed=8)
    out = hash_encode(torch.as_tensor(table), torch.as_tensor(x), cfg)
    assert calls == [(256, 3)]
    assert torch.equal(out, real(torch.as_tensor(table), torch.as_tensor(x),
                                 cfg))


def _bad(kind: str):
    cfg = HashGridConfig(**SMALL)
    table, x, _ = _inputs(cfg, 128, seed=9)
    t, xx = torch.as_tensor(table), torch.as_tensor(x)
    res = level_resolutions(cfg)
    if kind == "dtype":
        return t.double(), xx, res, TypeError
    if kind == "x_dtype":
        return t, xx.half(), res, TypeError
    if kind == "features":                       # an empty feature axis
        return t[:, :, :0].contiguous(), xx, res, ValueError
    if kind == "not_pow2":
        return t[:, :3000].contiguous(), xx, res, ValueError
    if kind == "non_contiguous":
        return t.transpose(0, 1).contiguous().transpose(0, 1), xx, res, \
            ValueError
    if kind == "levels":
        return t, xx, res[:-1], ValueError
    if kind == "x_shape":
        return t, xx[:, :2].contiguous(), res, ValueError
    return t, xx, res, ValueError      # "cpu": right in all but the device


@pytest.mark.parametrize("kind", ["dtype", "x_dtype", "features", "not_pow2",
                                  "non_contiguous", "levels", "x_shape",
                                  "cpu"])
def test_kernel_wrapper_checks_raise_before_build(monkeypatch, kind):
    """(c) The kernel wrapper's checks (dtype, no features, T not a power
    of two, a non-contiguous table, the levels, x's shape, and CPU tensors)
    raise before anything is built; ``hash_encode`` sends a CUDA-less
    mix of devices to the wrapper, which raises: nothing falls back."""
    def no_build():
        raise AssertionError("built before the checks")
    monkeypatch.setattr(kernel_mod, "build_hash_library", no_build)
    table, x, res, err = _bad(kind)
    with pytest.raises(err):
        kernel_mod.hash_encode_cuda(table, x, res)
    if kind == "cpu":
        cfg = HashGridConfig(**SMALL)
        with pytest.raises(ValueError):
            hash_encode(table, x.to("meta"), cfg)


@pytest.mark.parametrize("F,L,log2_T,ok", [
    (1, 16, 19, True), (3, 16, 19, True), (8, 16, 19, True),
    (2, 40, 14, True), (5, 64, 24, True),
    (2, 64, 25, False), (2, 65, 10, False)])
def test_kernel_wrapper_takes_any_width_and_64_levels(monkeypatch, F, L,
                                                       log2_T, ok):
    """(c) The wrapper's checks pass any F >= 1 and 1-64 levels with L * T
    < 2^31, before anything is built: on (meta) tensors right in all but
    the device, the only objection is the device; 64 levels of 2^25 rows
    (L * T = 2^31) and 65 levels raise on their own."""
    def no_build():
        raise AssertionError("built before the checks")
    monkeypatch.setattr(kernel_mod, "build_hash_library", no_build)
    table = torch.empty((L, 2 ** log2_T, F), device="meta")
    x = torch.empty((8, 3), device="meta")
    res = [16] * L
    match = "one CUDA device" if ok else "levels"
    with pytest.raises(ValueError, match=match):
        kernel_mod.hash_encode_cuda(table, x, res)


def test_counter_helper_adds_each_kernels_replays():
    """(d) ``captured_counts`` takes what a capture counted off every
    counted kernel and ``add_replay`` adds it back once per replay; the
    three graph modules count through it."""
    a = SimpleNamespace(launches=5, rows=50)
    b = SimpleNamespace(launches=1, rows=7)
    with counters.captured_counts((a, b)) as counts:
        a.launches, a.rows = a.launches + 2, a.rows + 20
        b.launches, b.rows = b.launches + 3, b.rows + 300
    assert counts == [(2, 20), (3, 300)]
    assert (a.launches, a.rows, b.launches, b.rows) == (5, 50, 1, 7)
    for _ in range(4):
        counters.add_replay(counts, (a, b))
    assert (a.launches, a.rows) == (13, 130)
    assert (b.launches, b.rows) == (13, 1207)
    assert counters.COUNTED == (counters.fused_field_head,
                                kernel_mod.hash_encode_cuda,
                                counters.nearest_vertex_cuda,
                                counters.nearest_warp_cuda)
    for mod in (step_graph, frame_graph, grid_graph):
        assert mod.add_replay is counters.add_replay
        assert mod.captured_counts is counters.captured_counts
