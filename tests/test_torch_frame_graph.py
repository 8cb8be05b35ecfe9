"""JAX's one-program eval frame in the port, on the CPU: the static
sample and cell budgets that ``RenderSession`` learns, the overflow
re-render, the pipelined ``render_frames``, a frame path that reads
nothing back to the host before its one fetch in the flat and in every
ray-bundle mode (the property that lets the card capture it as a CUDA
graph, ``train/graphs.py``), ``graph=True`` refused on a CPU model,
and ``DPFrameRenderer``'s budgets on spawned gloo ranks.

The scene is tests/test_torch_slice.py's (the opaque seeded
voxel-triplane avatar, SNARF res 32, grid 32, the shell grid) at 48 px.
Tolerances: the budgeted frame against the port's exact-count frame 1e-6
(the same per-sample arithmetic: the budget only pads the selections;
measured 0), against JAX's ``render_frame`` 40 dB (its ``_mlp`` head and
f16 payload against the fused-head numerics, as in test_torch_slice);
the learned budgets within one rounding granule of JAX's (4096 cells;
one chunk of ``RenderSession.round_budget`` for samples), since the two
packages' counts may differ by a sample or a cell.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.body import toy_smpl_model as jax_toy
from instantavatar_tpu.deformers import SNARFDeformer as JaxSNARF
from instantavatar_tpu.models import VoxelTriplaneField as JaxField
from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
from instantavatar_tpu.train import AvatarModel as JaxAvatar
from instantavatar_tpu.train.model import RenderSession as JaxSession
from instantavatar_torch import convert
from instantavatar_torch.parallel import (DPFrameRenderer, make_mesh,
                                          run_ranks)
from instantavatar_torch.train import RenderSession, TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_slice as slice_tests  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402  (no jax)
from test_torch_multi_step import NoHostRead  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

VR, PR, RES, GRID = slice_tests.VR, slice_tests.PR, slice_tests.RES, \
    slice_tests.GRID
H = 48
EXACT_ATOL = 1e-6
MIN_DB = 40.0
KEYS = ("rgb", "depth", "alpha", "counter")


def _avatar(pnp, **kw):
    av = slice_tests._port_avatar(VR, PR, RES, GRID, pnp)
    for k, v in kw.items():
        setattr(av, k, v)
    return av


def _max_gap(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in KEYS)


def _with_rays(batch: dict, h: int = H) -> dict:
    """The h x h px batch with its per-pixel ``rays_o``/``rays_d`` (the
    ray-bundle modes read them), from ``slice_tests._batch``'s camera."""
    from instantavatar_torch.data.rays import make_ray_grid
    f = 2000.0 * h / 540
    K = np.array([[f, 0, h / 2], [0, f, h / 2], [0, 0, 1]])
    ro, rd = make_ray_grid(K, np.eye(4), h, h)
    return {**batch, "rays_o": ro.reshape(-1, 3), "rays_d": rd.reshape(-1, 3)}


# the ray-bundle modes' knobs (JAX's AvatarModel knobs)
RAY_MODES = {"windows": dict(eval_sampling="windows"),
             "dense": dict(eval_sampling="dense"),
             "cache_fused_probe": dict(eval_sampling="dense",
                                       cache_fused_probe=True),
             "uncached": dict(use_warp_cache=False)}


def _exact(av, state, batch, grid, shape=(H, H)):
    """The port's exact-count frame: ``render_stream`` without budgets."""
    return av.composite_frame(av.render_stream(state, batch, grid, shape),
                              batch.get("bg_color"))


@pytest.fixture(scope="module")
def scene():
    """The port's avatar, state and shell grid at 48 px and 24 px, and
    JAX's ``render_frame`` of the sequence 48, 24, 48 px through one
    ``RenderSession`` (tests/test_e2e_slice.py:537's), on the same params,
    canonical state and grids."""
    pnp = convert.seeded_field_params(VR, PR, seed=3, sigma_bias=100.0)
    jbody = jax_toy(bone_rings=3)
    jav = JaxAvatar(jbody, JaxField(voxel_res=VR, plane_res=PR),
                    JaxSNARF(jbody, **slice_tests.SNARF_KW),
                    **slice_tests.AVATAR_KW)
    jstate = jav.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    jstate = jstate._replace(params={**jstate.params, "field":
                                     VoxelTriplaneParams(**{
                                         k: (tuple(map(jnp.asarray, v))
                                             if isinstance(v, list)
                                             else jnp.asarray(v))
                                         for k, v in pnp.items()})})
    av = _avatar(pnp)
    state = TrainState(
        deformer_cano=convert.snarf_canonical_from_numpy(
            jax.tree.map(np.asarray, jstate.deformer_cano), device="cpu"),
        grid=None, center=torch.as_tensor(np.array(jstate.center)),
        scale=torch.as_tensor(np.array(jstate.scale)))
    seq = [(H, slice_tests._batch(H)), (24, slice_tests._batch(24)),
           (H, slice_tests._batch(H))]
    jgrids = [jav.build_pose_grid(jstate, b) for _, b in seq[:2]]
    jsess = JaxSession()
    jout = [jav.render_frame(jstate, b, grid=jgrids[i % 2],
                             image_shape=(h, h), session=jsess)
            for i, (h, b) in enumerate(seq)]
    grids = [convert.grid_state_from_numpy(jax.tree.map(np.asarray, g),
                                           device="cpu") for g in jgrids]
    return {"pnp": pnp, "avatar": av, "state": state, "seq": seq,
            "grids": grids, "jax_session": jsess,
            "jax_rgb": np.asarray(jout[0]["rgb"])}


def test_budgeted_frame_equals_exact_and_jax(scene):
    """(a) With no overflow, the budgeted frame (static sample and cell
    budgets, padded selections) equals the exact-count frame to 1e-6, and
    is >= 40 dB from JAX's ``render_frame`` with a session."""
    av, state, grid = scene["avatar"], scene["state"], scene["grids"][0]
    b = scene["seq"][0][1]
    exact = _exact(av, state, b, grid)
    sess = RenderSession()
    out = av.render_frame(state, b, grid=grid, image_shape=(H, H),
                          session=sess)
    assert out["n_samples"] == int(exact["n_samples"]) > 0
    assert out["n_occ"] == int(grid.occupancy.sum())
    skey = (H * H, (H, H, 3))
    # the priors held the counts: one pass at budgets above them
    assert sess.samp_budget[skey] >= 8192 > out["n_samples"]
    assert _max_gap(out, exact) <= EXACT_ATOL
    assert slice_tests._psnr(out["rgb"].numpy(), scene["jax_rgb"]) >= MIN_DB


def test_session_budgets_match_jax(scene):
    """(b) After JAX's two-resolution sequence (48, 24, 48 px through one
    session), the port's session has JAX's keys, (n_rays, prepass
    shape), and each learned budget lies within one rounding granule of
    JAX's; revisiting 48 px reproduces the first frame."""
    av, state = scene["avatar"], scene["state"]
    sess = RenderSession()
    outs = [av.render_frame(state, b, grid=scene["grids"][i % 2],
                            image_shape=(h, h), session=sess)
            for i, (h, b) in enumerate(scene["seq"])]
    jsess = scene["jax_session"]
    assert set(sess.samp_budget) == set(jsess.samp_budget) \
        == {(H * H, (H, H, 3)), (24 * 24, (24, 24, 3))}
    assert set(sess.cell_budget) == set(jsess.cell_budget)
    for k, want in jsess.cell_budget.items():
        assert abs(sess.cell_budget[k] - want) <= 4096, k
    for k, want in jsess.samp_budget.items():
        chunk = RenderSession.round_budget(max(sess.samp_budget[k], want),
                                           32768)[1]
        assert abs(sess.samp_budget[k] - want) <= chunk, k
    assert _max_gap(outs[0], outs[2]) == 0.0


def test_session_cell_caps_of_the_two_renderers(scene):
    """The learned cell budget's cap (ROADMAP fault 1.11): after a cell
    overflow at a prior of 64 cells, the single-device frame's session
    learns a cell budget above the model's ``cell_budget``, at most G^3;
    ``DPFrameRenderer``'s session (2 bands in one process) never records
    one above ``cell_budget``. Each frame re-renders to its renderer's
    frame at the default prior, which does not overflow."""
    grid, b = scene["grids"][0], scene["seq"][0][1]
    av = _avatar(scene["pnp"], cell_budget=64)
    state = scene["state"]
    want = _exact(av, state, b, grid)
    sess = RenderSession()
    out = av.render_frame(state, b, grid=grid, image_shape=(H, H),
                          session=sess)
    assert out["n_occ"] > av.cell_budget
    learned = sess.cell_budget[(H * H, (H, H, 3))]
    assert av.cell_budget < learned <= GRID ** 3
    assert _max_gap(out, want) <= EXACT_ATOL
    dsess = RenderSession()
    dout = DPFrameRenderer(av, make_mesh(n_ray=2)).render_frame(
        state, b, grid=grid, image_shape=(H, H), session=dsess)
    assert dout["n_occ"] > av.cell_budget
    assert dsess.cell_budget and all(
        v <= av.cell_budget for v in dsess.cell_budget.values())
    free = DPFrameRenderer(_avatar(scene["pnp"]), make_mesh(
        n_ray=2)).render_frame(state, b, grid=grid, image_shape=(H, H))
    assert _max_gap(dout, free) <= EXACT_ATOL


@pytest.mark.parametrize("renderer,renders", [
    ("single", 5), ("dp_frame", 5), ("dp_band", 4)])
def test_overflow_passes_are_capped(scene, monkeypatch, renderer, renders):
    """A frame whose counts overflow at every pass: the single-device and
    DP frames render once and re-render at most 4 times, a DP band
    renders at most 4 times in all; each then warns that the image is
    truncated."""
    from instantavatar_torch.train import model as model_mod
    grid, b = scene["grids"][0], scene["seq"][0][1]
    av, state = _avatar(scene["pnp"]), scene["state"]
    monkeypatch.setattr(model_mod, "_overflow", lambda rec, n_hit, n_occ:
                        (True, False))
    calls = []

    def counted(obj, name):
        fn = getattr(obj, name)
        monkeypatch.setattr(obj, name, lambda *a, **k: (
            calls.append(name), fn(*a, **k))[1])

    kw = dict(grid=grid, image_shape=(H, H))
    with pytest.warns(RuntimeWarning, match=f"after {renders - 1} re-r"):
        if renderer == "single":
            counted(av, "_dispatch_frame")
            av.render_frame(state, b, **kw)
        else:
            rend = DPFrameRenderer(av, make_mesh(n_ray=2))
            if renderer == "dp_frame":
                counted(rend, "_dispatch")
                rend.render_frame(state, b, **kw)
            else:
                counted(rend, "_band")
                rend.render_band(state, b, 1, **kw)
    assert len(calls) == renders


@pytest.mark.parametrize("mode", ["flat", "dense"])
def test_overflow_rerenders_to_the_same_frame(scene, mode):
    """(c) Priors too small for the frame (flat: 0.05 samples per block
    and 64 cells; dense: 1% of the rays and 64 cells) overflow on the
    first pass; the frame re-renders (rebaking for the cells) to the
    exact-count frame, as tests/test_e2e_slice.py:705 holds JAX's."""
    grid, b = scene["grids"][0], scene["seq"][0][1]
    av = _avatar(scene["pnp"], cell_budget=64, samples_per_ray=0.05)
    state = scene["state"]
    if mode == "dense":
        av.eval_sampling = "dense"
        b = _with_rays(b)
    passes = []
    dispatch = av._dispatch_frame
    av._dispatch_frame = lambda rec, rebake=False: (
        passes.append((rec.get("samp_budget", rec.get("ray_budget")),
                       rec["cell_budget"], rebake)), dispatch(rec, rebake))
    rec = av._render_frame_async(state, b, grid=grid, image_shape=(H, H),
                                 ray_budget_frac=0.01)
    out = av._finish_frame(rec)
    first = passes[0]
    assert first[1] < out["n_occ"] and len(passes) >= 2
    assert any(p[2] for p in passes[1:])     # a cell overflow rebakes
    assert out["n_samples"] > 0
    if mode == "flat":
        assert first[0] < out["n_samples"]
        want = _exact(av, state, b, grid)
    else:
        want = av.render_rays_frame(state, b, grid, (H, H))
    assert _max_gap(out, want) <= EXACT_ATOL


def test_persistent_overflow_warns(scene):
    """(d) A frame whose counts overflow every budget it is given
    re-renders 4 times, then warns that it is truncated
    (tests/test_e2e_slice.py:818)."""
    av, state = scene["avatar"], scene["state"]
    grid, b = scene["grids"][0], scene["seq"][0][1]
    rec = av._render_frame_async(state, b, grid=grid, image_shape=(H, H))

    def always_over(rec, rebake=False):
        rerenders.append(rec["samp_budget"])
        rec["counts"] = lambda: [2 * rec["samp_budget"], 0, 0]

    rerenders = []
    always_over(rec)
    first = rerenders.pop()
    av._dispatch_frame = always_over
    try:
        with pytest.warns(RuntimeWarning, match="still overflowed"):
            out = av._finish_frame(rec)
    finally:
        del av._dispatch_frame
    assert len(rerenders) == 4
    # each pass takes the budget learned from the last pass's count
    assert rerenders == sorted(set(rerenders))
    assert rerenders[0] >= 1.2 * 2 * first
    assert out["rgb"].shape == (H * H, 3)


def test_render_frames_pipelined_matches_frame_by_frame(scene):
    """(e) ``render_frames(depth=2)`` (frame i+1 enqueued at the priors
    before frame i's counts are read) equals ``render_frame`` called
    frame by frame through one session, on a turntable and a new pose
    (tests/test_e2e_slice.py:747): the same bakes and reuses, budgets
    that only pad."""
    av, state, grid = scene["avatar"], scene["state"], scene["grids"][1]
    b0 = slice_tests._batch(24, yaw=0.0)
    frames = [b0, slice_tests._batch(24, yaw=0.4),
              slice_tests._batch(24, yaw=0.8),
              {**b0, "body_pose": b0["body_pose"] + 0.1}]
    piped = list(av.render_frames(state, frames, grid=grid,
                                  image_shape=(24, 24), depth=2))
    sess = RenderSession()
    single = [av.render_frame(state, f, grid=grid, image_shape=(24, 24),
                              session=sess) for f in frames]
    assert len(piped) == 4
    for p, s in zip(piped, single):
        assert _max_gap(p, s) <= EXACT_ATOL
        assert p["n_samples"] == s["n_samples"]


@pytest.mark.parametrize("case", [
    "given", "smpl_shell", "density", "shared_corner_eval",
    "flat_tile_rows", "term_T_none", "alpha_skip", *RAY_MODES])
def test_frame_reads_nothing_back(scene, case):
    """(f) Given tensors, the budgeted flat frame up to its fetch
    (``_render_frame_async``), with the grid given or built by
    ``build_pose_grid`` or ``build_test_grid``, and both grid builders
    alone, make no host read (after one eager frame, which makes the
    cached constants); so does the frame in each flat mode that a CUDA
    model captures (shared-corner eval, tiled rows, no transmittance cut,
    the alpha skip) and in each ray-bundle mode (windows, dense, the
    probed dense march, uncached: ``_rays_frame`` at its ray and cell
    budgets), with the grid given. The ray-bundle frame equals
    ``render_rays_frame``'s exact-count frame."""
    knobs = {"shared_corner_eval": dict(shared_corner_eval=True),
             "flat_tile_rows": dict(flat_tile_rows=True),
             "term_T_none": dict(term_T=None),
             "alpha_skip": dict(alpha_skip=0.01),
             **RAY_MODES}.get(case, {})
    eval_grid = case if case in ("smpl_shell", "density") else "given"
    av = _avatar(scene["pnp"], eval_grid="smpl_shell" if eval_grid
                 == "given" else eval_grid, **knobs)
    state, grid = scene["state"], scene["grids"][0]
    batch = scene["seq"][0][1]
    if case in RAY_MODES:
        batch = _with_rays(batch)
    b = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    given = grid if eval_grid == "given" else None
    want = (av.render_rays_frame(state, b, grid, (H, H)) if case
            in RAY_MODES else av.render_frame(state, b, grid=given,
                                              image_shape=(H, H)))
    with NoHostRead():
        rec = av._render_frame_async(state, b, grid=given,
                                     image_shape=(H, H))
        build = (av.build_test_grid if eval_grid == "density"
                 else av.build_pose_grid)
        built = build(state, b)
    assert torch.equal(built.occupancy,
                       grid.occupancy if eval_grid == "given"
                       else rec["grid"].occupancy)
    out = av._finish_frame(rec)
    assert _max_gap(out, want) <= EXACT_ATOL
    if case in RAY_MODES:
        assert out["n_samples"] == int(want["n_samples"]) > 0


@pytest.mark.parametrize("mode", ["flat", *RAY_MODES])
def test_graph_true_raises_on_cpu(scene, mode):
    """``graph=True`` (a captured frame) on a CPU model raises in the flat
    and in each ray-bundle mode, before any frame is rendered; the
    default (None) renders eagerly there and captures nothing."""
    av = _avatar(scene["pnp"], **RAY_MODES.get(mode, {}))
    state, grid = scene["state"], scene["grids"][1]
    b = slice_tests._batch(24)
    if mode in RAY_MODES:
        b = _with_rays(b, 24)
    with pytest.raises(ValueError, match="CUDA model"):
        av.render_frame(state, b, grid=grid, image_shape=(24, 24),
                        graph=True)
    assert av.frame_graphs is None
    out = av.render_frame(state, b, grid=grid, image_shape=(24, 24))
    assert out["rgb"].shape == (24 * 24, 3) and av.frame_graphs is None


def test_dp_overflow_on_gloo_ranks(scene, tmp_path):
    """(g) ``DPFrameRenderer`` on 2 spawned gloo ranks, one band each:
    with priors too small for the bands' samples and cells the frame
    overflows, both ranks re-render (rebaking) on the gathered counts,
    and the frame equals the unforced one; both ranks hold the same
    frame, within 1e-6 of the same bands rendered in one process."""
    av = _avatar(scene["pnp"])
    state, grid = scene["state"], scene["grids"][0]
    frame = scene["seq"][0][1]
    spec = {"voxel_res": VR, "plane_res": PR, "snarf": slice_tests.SNARF_KW,
            "avatar": slice_tests.AVATAR_KW,
            "field": convert.field_params_from_numpy(scene["pnp"]),
            "cano": state.deformer_cano, "center": state.center,
            "scale": state.scale, "grid": grid}
    torch.save({"scene": spec, "frame": frame, "image_shape": (H, H),
                "tiny": (0.05, 64)}, tmp_path / "inputs.pt")
    run_ranks(workers.overflow_rank, 2, backend="gloo", store_dir=tmp_path,
              args=(str(tmp_path),), timeout=120.0, threads=1)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    ref = DPFrameRenderer(av, make_mesh(n_ray=2)).render_frame(
        state, frame, grid=grid, image_shape=(H, H))
    for r in ranks:
        assert len(r["passes"]) >= 2 and any(r["passes"][1:])
        assert r["forced"]["n_samples"] == r["free"]["n_samples"] \
            == ref["n_samples"]
        assert _max_gap(r["forced"], r["free"]) <= EXACT_ATOL
        assert _max_gap(r["forced"], ref) <= EXACT_ATOL
    assert _max_gap(ranks[0]["forced"], ranks[1]["forced"]) == 0.0
