"""JAX's one-program DP and multi-subject steps in the port, on the CPU:
the step body that a CUDA model captures for a ray-data-parallel step
(``grads_and_losses(in_place=True)``, the ray group's ``all_reduce`` of
one bucket written back in place, the optimizer) reads nothing back to
the host and leaves what the eager DP step leaves, bit for bit; the
multi-subject step reads nothing back between its subjects;
``graph=True`` is refused on the CPU and on a gloo group, whose
collectives cannot be captured; and ``make_dp_render``'s per-shard eval
render (the program a CUDA model captures, the gather outside it) reads
nothing back and equals ``render(eval_mode=True)`` of each shard.

The ray group is a real in-process gloo group of one rank (a FileStore
under the test's tmp dir), so the ``all_reduce`` runs; the eager DP step
on it is held against JAX's by tests/test_torch_parallel.py. The scene is
the golden configuration (tools/make_torch_train_golden.py) at a 16^3
grid, on one 16^2 patch of its batches. Tolerance: exact (the same kernels in the same
order on both sides)."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instantavatar_torch.parallel import (Mesh, make_dp_render,
                                          make_dp_train_step, make_mesh,
                                          make_multi_subject_step,
                                          shard_batch, stack_subjects)
from instantavatar_torch.parallel.data_parallel import _ray_reduce
from instantavatar_torch.train.graphs import step_body

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402  (no jax)
from test_torch_multi_step import NoHostRead  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

golden_tool = workers.golden_tool
C = golden_tool.CONFIG
N_RAYS = C["patch_size"] ** 2
# the golden configuration at a 16^3 grid and 64 samples per ray (16
# evaluated): the grid update's sweep is 8x smaller
SMALL = dict(grid_size=16, n_steps=64, k_cap=16)


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A world of one gloo rank in this process and its ray mesh (a real
    group, not None); the process group is gone after the module."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(n_ray=1)
        assert mesh.group is not None
        yield mesh
    finally:
        dist.destroy_process_group()


def _batch(i: int = 0) -> dict:
    """The first 16^2 patch of golden batch ``i``, as CPU tensors."""
    b = shard_batch(golden_tool.scene_batches()[i], Mesh(1, 2, 0, 0), ray=0)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def _subject(seed: int = 0):
    av = golden_tool.port_avatar(**SMALL)
    b = golden_tool.scene_batches()[0]
    return av, av.init(b["betas"], generator=torch.Generator()
                       .manual_seed(seed))


def _left(av, state, losses) -> list[torch.Tensor]:
    """What a step leaves: parameters, gradients, Adam moments and counts,
    the grid and the losses."""
    opt = state.opt_state
    mom = opt.moments("field")
    out = [p.detach() for p in av.field.parameters()]
    out += [p.grad for p in av.field.parameters()]
    out += mom[0] + mom[1] + [opt.count, opt.notfinite_count, *state.grid]
    return out + [losses[k] for k in sorted(losses)]


@pytest.mark.parametrize("update", [True, False], ids=["update", "plain"])
def test_dp_step_body_reads_nothing_back(gloo_mesh, update):
    """The captured DP step's body on the gloo group of one rank, after
    the capture's eager warm-up (which makes the cached constants and runs
    the group's all_reduce once), makes no host read at a grid-update
    and a plain step, and leaves the eager DP step's parameters,
    gradients, moments, counts, grid (written in place into the state's
    own tensors) and losses bit for bit."""
    b = _batch()
    (av1, st1), (av2, st2) = _subject(), _subject()
    d = av1.draw(torch.Generator().manual_seed(3), N_RAYS, update)
    st1, want = make_dp_train_step(av1, gloo_mesh, update, graph=False)(
        st1, b, d)
    reduce = _ray_reduce(gloo_mesh)
    assert reduce[0] is gloo_mesh.group
    losses, grid = av2.grads_and_losses(st2, b, d, update)   # the warm-up
    reduce[1](st2.opt_state.params, losses, grid, False)
    grid_tensors = [t.data_ptr() for t in st2.grid]
    with NoHostRead():
        losses = step_body(av2, st2, shard_batch(b, gloo_mesh), d, update,
                           reduce)
    assert [t.data_ptr() for t in st2.grid] == grid_tensors
    assert losses.keys() == want.keys()
    for i, (x, y) in enumerate(zip(_left(av1, st1, want),
                                   _left(av2, st2, losses), strict=True)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("builder", ["dp", "multi_subject"])
def test_graph_true_raises_on_cpu_and_gloo(gloo_mesh, builder):
    """``graph=True`` on a gloo ray group (which cannot be captured) and
    on a CPU model raises ValueError, for both step builders; by default
    the CPU and the gloo group run eagerly."""
    av, st = _subject()
    alone = Mesh(1, 1, 0, 0, None)
    b = _batch()
    d = av.draw(torch.Generator().manual_seed(4), N_RAYS, False)
    if builder == "dp":
        with pytest.raises(ValueError, match="gloo"):
            make_dp_train_step(av, gloo_mesh, graph=True)
        with pytest.raises(ValueError, match="CUDA model"):
            make_dp_train_step(av, alone, graph=True)
        st, _ = make_dp_train_step(av, gloo_mesh)(st, b, d)
    else:
        with pytest.raises(ValueError, match="gloo"):
            make_multi_subject_step(gloo_mesh, graph=True)
        with pytest.raises(ValueError, match="CUDA model"):
            make_multi_subject_step(alone, graph=True)([(av, st)], [b], [d])
        [(_, st)], _ = make_multi_subject_step(gloo_mesh)([(av, st)], [b],
                                                          [d])
    assert st.step == 1 and av.step_graphs is None


def test_multi_subject_step_reads_nothing_back(gloo_mesh):
    """Two subjects on the gloo group of one rank: after one combined
    grid-update step (the warm-up), a combined plain step makes no host
    read from its first subject's step to its last, and each subject
    moves as its own eager DP steps move it."""
    subjects = stack_subjects([_subject(0), _subject(1)])
    refs = [_subject(0), _subject(1)]
    batches = [_batch(0), _batch(1)]
    gen = [torch.Generator().manual_seed(10 + k) for k in range(2)]
    draws = [[av.draw(g, N_RAYS, u) for (av, _), g in zip(subjects, gen)]
             for u in (True, False)]
    subjects, _ = make_multi_subject_step(gloo_mesh, True)(
        subjects, batches, draws[0])
    step = make_multi_subject_step(gloo_mesh, False)
    with NoHostRead():
        subjects, losses = step(subjects, batches, draws[1])
    for k, ((av, st), (rav, rst)) in enumerate(zip(subjects, refs)):
        for u, d in ((True, draws[0][k]), (False, draws[1][k])):
            rst, rl = make_dp_train_step(rav, gloo_mesh, u)(rst, batches[k],
                                                            d)
        assert st.step == rst.step == 2
        for i, (x, y) in enumerate(zip(_left(av, st, losses[k]),
                                       _left(rav, rst, rl), strict=True)):
            assert torch.equal(x, y), (k, i)


def _whole_batch(i: int = 0) -> dict:
    """Golden batch ``i`` (two 16^2 patches) as CPU tensors."""
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in golden_tool.scene_batches()[i].items()}


@pytest.mark.parametrize("layout", ["two_shards", "gloo"])
def test_dp_render_reads_nothing_back(gloo_mesh, layout):
    """``make_dp_render`` over two ray shards rendered in turn (a world of
    1) and on the gloo group of one rank (its all_gather included): after
    one call, which makes the cached constants, a call makes no host read
    from its first shard's eval render (``AvatarModel._eval_render``: the
    full search per sample, the eval head) to the gathered frame, and the
    frame equals ``render(eval_mode=True)`` of each shard, bit for bit
    (samples evaluated: the counter is not all zero)."""
    av, st = _subject()
    mesh = Mesh(1, 2, 0, 0, None) if layout == "two_shards" else gloo_mesh
    b = _whole_batch()
    render = make_dp_render(av, mesh)
    render(st, b, st.grid)
    with NoHostRead():
        out = render(st, b, st.grid)
    shards = [av.render(st, shard_batch(b, mesh, c), grid=st.grid,
                        eval_mode=True) for c in range(mesh.n_ray)]
    for k in ("rgb", "depth", "alpha", "counter"):
        want = torch.cat([s[k].float() for s in shards]) \
            .reshape(out[k].shape)
        assert torch.equal(out[k], want), k
    assert float(out["counter"].sum()) > 0 and av.frame_graphs is None


def test_dp_render_graph_true_raises_on_cpu(gloo_mesh):
    """``make_dp_render(graph=True)`` on a CPU model raises ValueError, in
    a world of 1 and on the gloo group (whose gather sits outside the
    graph, so only the CPU refuses)."""
    av, _ = _subject()
    for mesh in (Mesh(1, 2, 0, 0, None), gloo_mesh):
        with pytest.raises(ValueError, match="CUDA model"):
            make_dp_render(av, mesh, graph=True)
