"""The port's parallel layer (``instantavatar_torch.parallel``) against
``instantavatar_tpu.parallel`` on the CPU, mirroring tests/test_parallel.py
on the conftest's 8-device mesh.

JAX runs its shard_map programs on ``make_mesh(n_ray=R,
devices=jax.devices()[:R])``; the port runs ranks of a gloo process group
spawned on this host (``run_ranks``: the spawn start method, a FileStore
under the test's tmp_path, one torch thread per rank, and a timeout that
stops every rank and fails the test), or, for the renderers, every band in
one process. Three runs are spawned: the DP steps (2 ranks), the 2 x 2
subject x ray step (4 ranks) and the DP renders (2 ranks).

Random draws: ray shard r of a JAX step with key k draws its render
jitter and noise from ``fold_in(k, r)`` and the grid jitter from k
(``grid_key``); the port's ranks are given those same draws
(``tools/make_torch_train_golden.py:jax_draws``). Tolerances:

  * losses 1e-3 relative, reg_density 5e-5 absolute, averaged gradients
    1.5e-2 L2-relative per leaf, the updated grid's occupancy exactly and
    its density 1e-4: tests/test_torch_train.py's update-step tolerances.
    The parameters after a first Adam step (eps 1e-15) move by +-lr
    wherever a gradient is non-zero, so a 1e-9 gradient that the two
    packages round to opposite signs moves them 2 lr apart: they are
    held through the averaged gradients the step applied, and JAX's own
    step is checked to apply the mean of its per-shard gradients (1e-6);
  * the DP step against the port's single-process step on the
    concatenated batch with the concatenated draws: losses 1e-4 relative,
    the grid exactly, gradients at 1.5e-2 like JAX's: the per-ray
    arithmetic is the same, but the fp32 matmuls of two half batches may
    sum in another order than one whole batch, and a last-bit difference
    at one of _mlp's bf16 casts moves that value by 2^-8 (measured
    2.4e-3; the fp32 output layer's bias agrees to 8e-8);
  * parameters bit-identical on every rank of a ray group; S subjects in
    one process exactly equal to S independent steps;
  * frames: >= 40 dB rgb against JAX's (its _mlp head and f16 payload
    against the port's fused-head numerics, tests/test_torch_eval_modes.py)
    and JAX's atol 2e-3 against the port's single-device frame (a band
    composites its own stream, whose cumulative sums start at the band's
    first sample); the spawned ranks' gathered frame within 1e-5 of the
    same bands rendered in one process.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.parallel import data_parallel as jdp
from instantavatar_torch import convert
from instantavatar_torch.parallel import (PER_FRAME, DPFrameRenderer,
                                          dp_render_frame, make_dp_render,
                                          make_mesh, make_multi_subject_step,
                                          rank_draws, run_ranks, shard_batch,
                                          stack_subjects)
from instantavatar_torch.train import RenderSession, StepDraws

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402  (no jax)

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

golden_tool = workers.golden_tool
C = golden_tool.CONFIG
LOSS_RTOL = golden_tool.LOSS_RTOL                # 1e-3
REG_DENSITY_ATOL = golden_tool.REG_DENSITY_ATOL  # 5e-5
GRAD_RTOL = golden_tool.GRAD_RTOL                # 1.5e-2
SINGLE_RTOL = 1e-4
SPAWN_TIMEOUT = 120.0
MIN_DB = 40.0
R = 2                      # ray shards of the training steps
LOSS_KEYS = ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy", "loss")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _slice(batch, r, n):
    """Ray shard r of n: JAX's P("ray") split of the per-ray leaves."""
    out = {}
    for k, v in batch.items():
        if k in PER_FRAME or np.ndim(v) == 0:
            out[k] = v
        else:
            m = np.shape(v)[0] // n
            out[k] = v[r * m:(r + 1) * m]
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _host(tree):
    """A mesh program's (replicated) outputs as single-device arrays."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


def _draws_for(key, n_loc, upd, n=R):
    """The port's per-shard draws of JAX's step key: shard r's jitter and
    noise from fold_in(key, r), the grid jitter from key itself."""
    grid = golden_tool.jax_draws(key, n_loc, grid_update=upd)
    out = []
    for r in range(n):
        d = golden_tool.jax_draws(jax.random.fold_in(key, r), n_loc,
                                  grid_update=False)
        out.append({"jitter": torch.tensor(d["jitter"]),
                    "noise": torch.tensor(d["noise"]),
                    "grid_jitter": (torch.tensor(grid["grid_jitter"])
                                    if upd else None)})
    return out


def _field_grads(tree):
    return {k: v.numpy() for k, v in convert.field_params_from_numpy(
        jax.tree.map(np.asarray, tree)).items()}


def _ray_batch(n_rays, seed=0):
    """tests/test_parallel.py's ray batch (numpy)."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n_rays, 3).astype(np.float32) * 0.05 + [0, 0, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": np.zeros((n_rays, 3), np.float32),
            "rays_d": d.astype(np.float32),
            "near": np.full((n_rays,), 2.0, np.float32),
            "far": np.full((n_rays,), 4.0, np.float32),
            "rgb": rng.rand(n_rays, 3).astype(np.float32),
            "alpha": (rng.rand(n_rays) > 0.5).astype(np.float32),
            "bg_color": np.ones((n_rays, 3), np.float32),
            "betas": np.zeros((10,), np.float32),
            "body_pose": np.zeros((69,), np.float32),
            "global_orient": np.zeros((3,), np.float32),
            "transl": np.asarray([0.0, 0.0, 3.0], np.float32),
            "idx": np.int32(0)}


# -- layout -----------------------------------------------------------------

def test_mesh_shape():
    """Without a process group a mesh is a world of 1 with the layout's
    shape; it holds every subject, and JAX's mesh has the same shape."""
    mesh = make_mesh(n_ray=4, n_subject=2)
    assert mesh.shape == {"subject": 2, "ray": 4} \
        == dict(jdp.make_mesh(n_ray=4, n_subject=2).shape)
    assert (mesh.subject, mesh.ray, mesh.group) == (0, 0, None)
    assert mesh.local_subjects(3) == [0, 1, 2]
    assert make_mesh().shape == {"subject": 1, "ray": 1}


def test_shard_batch_matches_jax():
    """Each ray shard of the port's ``shard_batch`` equals the shard JAX's
    ``shard_batch`` puts on that device of a 4-way ray mesh, exactly; the
    per-frame leaves stay whole."""
    n = 4
    batch = _ray_batch(64)
    jmesh = jdp.make_mesh(n_ray=n, devices=jax.devices()[:n])
    jsharded = jdp.shard_batch(jmesh, _jb(batch))
    devices = list(jmesh.devices.reshape(-1))
    mesh = make_mesh(n_ray=n)
    for r in range(n):
        mine = shard_batch(batch, mesh, ray=r)
        tb = shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                         mesh, ray=r)
        for k, v in jsharded.items():
            (shard,) = [s for s in v.addressable_shards
                        if s.device == devices[r]]
            want = np.asarray(shard.data)
            np.testing.assert_array_equal(np.asarray(mine[k]), want,
                                          err_msg=k)
            np.testing.assert_array_equal(tb[k].numpy(), want, err_msg=k)
            if k in PER_FRAME:
                np.testing.assert_array_equal(want, batch[k])
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(_ray_batch(6), mesh)


def test_rank_draws():
    """One ray shard: the single-device draws of the seed; several: each
    shard's own jitter and noise, the grid jitter shared."""
    av = golden_tool.port_avatar()
    one = rank_draws(av, make_mesh(), 7, 32, True)
    ref = av.draw(torch.Generator().manual_seed(7), 32, True)
    for a, b in zip(one, ref):
        assert torch.equal(a, b)
    mesh = make_mesh(n_ray=2)
    d0, d1 = (rank_draws(av, mesh, 7, 32, True, ray=r) for r in (0, 1))
    assert d0.jitter.shape == (32, C["n_steps"])
    assert d0.noise.shape == (32, C["k_cap"])
    assert not torch.equal(d0.jitter, d1.jitter)
    assert torch.equal(d0.grid_jitter, d1.grid_jitter)
    assert rank_draws(av, mesh, 7, 32, False).grid_jitter is None


# -- the DP training step ----------------------------------------------------

@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """JAX's DP update step (state 0, batch 0, key0) and plain step (its
    state 1, batch 1, key1) on a 2-way ray mesh, with the mean of its
    per-shard gradients; the port's 2 spawned ranks on the same states
    (as checkpoints), batches and draws; and the port's single-process
    steps on the whole batches with the concatenated draws."""
    work = tmp_path_factory.mktemp("dp")
    b0, b1 = golden_tool.scene_batches()
    jav = golden_tool.jax_avatar()
    st = golden_tool.jax_state0(jav, b0["betas"])
    jmesh = jdp.make_mesh(n_ray=R, devices=jax.devices()[:R])
    grads = jax.jit(jav.grads_and_losses, static_argnums=3)
    n_loc = C["num_patch"] * C["patch_size"] ** 2 // R
    port = golden_tool.port_avatar()
    steps = []
    for i, (b, key, upd) in enumerate(((b0, C["key0"], True),
                                       (b1, C["key1"], False))):
        k = jax.random.PRNGKey(key)
        with jmesh:
            new, jl = jdp.make_dp_train_step(jav, jmesh, upd)(
                st, jdp.shard_batch(jmesh, _jb(b)), k)
        new = _host(new)
        shard = [grads(st, _jb(_slice(b, r, R)), jax.random.fold_in(k, r),
                       upd, k) for r in range(R)]
        mean = jax.tree.map(lambda *g: sum(g) / R, *[s[0] for s in shard])
        ckpt = convert.checkpoint_from_jax_state(
            jax.tree.map(np.asarray, st), port.field, port, work / f"s{i}")
        steps.append({"batch": b, "upd": upd, "state": st, "new": new,
                      "losses": {kk: float(v) for kk, v in jl.items()},
                      "mean_grads": mean, "ckpt": ckpt,
                      "draws": _draws_for(k, n_loc, upd)})
        st = new
    torch.save({"ckpts": [s["ckpt"] for s in steps], "betas": b0["betas"],
                "batches": [b0, b1], "draws": [s["draws"] for s in steps]},
               work / "inputs.pt")
    run_ranks(workers.dp_step_rank, R, backend="gloo", store_dir=work,
              args=(str(work),), timeout=SPAWN_TIMEOUT, threads=1)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(R)]
    for i, s in enumerate(steps):
        state = workers.port_state(port, s["ckpt"], b0["betas"])
        d = s["draws"]
        draws = StepDraws(torch.cat([x["jitter"] for x in d]),
                          torch.cat([x["noise"] for x in d]),
                          d[0]["grid_jitter"])
        step = port.train_step_update if s["upd"] else port.train_step
        state, losses = step(state, s["batch"], draws)
        s["single"] = workers.step_record(port, state, losses)
        s["ranks"] = [rk[i] for rk in ranks]
    return {"jav": jav, "grads": grads, "steps": steps}


@pytest.mark.parametrize("i", [0, 1], ids=["update", "plain"])
def test_dp_step_matches_jax(dp_case, i):
    """The port's 2-rank DP step against JAX's ``make_dp_train_step``:
    losses, the averaged gradients, the grid; parameters bit-identical on
    both ranks; JAX's step applies the mean of its shards' gradients."""
    s = dp_case["steps"][i]
    jav = dp_case["jav"]
    r0, r1 = s["ranks"]
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    assert r0["losses"] == r1["losses"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(r0["losses"][k], s["losses"][k],
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(r0["losses"]["reg_density"],
                               s["losses"]["reg_density"],
                               atol=REG_DENSITY_ATOL)
    want = _field_grads(s["mean_grads"]["field"])
    rels = {n: _rel(g.numpy(), want[n]) for n, g in r0["grads"].items()}
    assert max(rels.values()) <= GRAD_RTOL, rels
    np.testing.assert_array_equal(r0["occupancy"].numpy(),
                                  np.asarray(s["new"].grid.occupancy))
    np.testing.assert_allclose(r0["density"].numpy(),
                               np.asarray(s["new"].grid.density_cached),
                               rtol=1e-4, atol=1e-4)
    applied = jav.apply_grads(s["state"], s["mean_grads"], s["new"].grid)
    for a, b in zip(jax.tree.leaves(applied.params),
                    jax.tree.leaves(s["new"].params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("i", [0, 1], ids=["update", "plain"])
def test_dp_step_matches_single_process(dp_case, i):
    """The 2-rank DP step against the port's single-process step on the
    concatenated batch fed the concatenated draws."""
    s = dp_case["steps"][i]
    r0, one = s["ranks"][0], s["single"]
    for k in LOSS_KEYS + ("reg_density", "counter_avg"):
        np.testing.assert_allclose(r0["losses"][k], one["losses"][k],
                                   rtol=SINGLE_RTOL, atol=1e-9, err_msg=k)
    rels = {n: _rel(g.numpy(), one["grads"][n].numpy())
            for n, g in r0["grads"].items()}
    assert max(rels.values()) <= GRAD_RTOL, rels
    assert torch.equal(r0["occupancy"], one["occupancy"])
    assert torch.equal(r0["density"], one["density"])


# -- subject parallelism -----------------------------------------------------

def test_multi_subject_independence():
    """S = 4 subjects stepped in one process (a world of 1) by the
    multi-subject step, with grid update, against 4 independent
    ``train_step_update`` calls: parameters, losses and grids exactly."""
    b = _slice(golden_tool.scene_batches()[0], 0, 2)   # one 16^2 patch
    n_rays = C["patch_size"] ** 2
    mesh = make_mesh(n_ray=1, n_subject=4)

    def subject(k):
        av = golden_tool.port_avatar()
        av.field.load_state_dict(convert.field_params_from_numpy(
            convert.seeded_field_params(C["voxel_res"], C["plane_res"], k,
                                        feat_std=C["feat_std"],
                                        sigma_bias=C["sigma_bias"])))
        return av, av.init(b["betas"])
    subjects = stack_subjects([subject(k) for k in mesh.local_subjects(4)])
    draws = [rank_draws(av, mesh, 100 + k, n_rays, True)
             for k, (av, _) in enumerate(subjects)]
    new, losses = make_multi_subject_step(mesh, with_grid_update=True)(
        subjects, [b] * 4, draws)
    for k in range(4):
        av, st = subject(k)
        st, ref = av.train_step_update(
            st, b, av.draw(torch.Generator().manual_seed(100 + k), n_rays,
                           True))
        mav, mst = new[k]
        for (n, p), q in zip(av.field.named_parameters(),
                             mav.field.parameters()):
            assert torch.equal(p, q), (k, n)
        assert {kk: float(v) for kk, v in ref.items()} == \
            {kk: float(v) for kk, v in losses[k].items()}
        assert torch.equal(st.grid.occupancy, mst.grid.occupancy)
        assert mst.step == 1


def test_combined_subject_ray_mesh(dp_case, tmp_path):
    """2 subjects x 2 ray shards: 4 spawned ranks against JAX's
    ``make_multi_subject_step`` on a (2, 2) mesh with the grid update. Per
    subject: losses, the averaged gradients (against the mean of JAX's
    per-shard gradients, whose losses JAX's step reproduces) and the grid
    at the DP step's tolerances, parameters bit-identical on its two
    ranks."""
    jav, grads = dp_case["jav"], dp_case["grads"]
    b0, b1 = golden_tool.scene_batches()
    batches = [b0, b1]
    states = [golden_tool.jax_state0(jav, b0["betas"]),
              golden_tool.jax_state0(jav, b0["betas"],
                                     {**C, "param_seed": 1})]
    keys = [jax.random.PRNGKey(200 + s) for s in range(2)]
    jmesh = jdp.make_mesh(n_ray=2, n_subject=2, devices=jax.devices()[:4])
    with jmesh:
        new, jl = jdp.make_multi_subject_step(jav, jmesh, True)(
            jdp.stack_subjects(states),
            jax.tree.map(lambda *xs: jnp.stack(xs), *map(_jb, batches)),
            jnp.stack(keys))
    new, jl = _host(new), _host(jl)
    n_loc = C["num_patch"] * C["patch_size"] ** 2 // 2
    port = golden_tool.port_avatar()
    ckpts = [convert.checkpoint_from_jax_state(
        jax.tree.map(np.asarray, st), port.field, port, tmp_path / f"s{s}")
        for s, st in enumerate(states)]
    torch.save({"ckpts": ckpts, "betas": b0["betas"], "batches": batches,
                "draws": [_draws_for(k, n_loc, True) for k in keys]},
               tmp_path / "inputs.pt")
    run_ranks(workers.multi_subject_rank, 4, backend="gloo",
              store_dir=tmp_path, args=(str(tmp_path),),
              timeout=SPAWN_TIMEOUT, threads=1)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    for s in range(2):
        ra, rb = ranks[2 * s], ranks[2 * s + 1]
        assert ra["subject"] == rb["subject"] == s
        for n, p in ra["params"].items():
            assert torch.equal(p, rb["params"][n]), (s, n)
        shard = [grads(states[s], _jb(_slice(batches[s], r, 2)),
                       jax.random.fold_in(keys[s], r), True, keys[s])
                 for r in range(2)]
        want = _field_grads(jax.tree.map(lambda *g: sum(g) / 2,
                                         *[x[0]["field"] for x in shard]))
        rels = {n: _rel(g.numpy(), want[n]) for n, g in ra["grads"].items()}
        assert max(rels.values()) <= GRAD_RTOL, (s, rels)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(ra["losses"][k],
                                       float(np.asarray(jl[k])[s]),
                                       rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg=f"subject {s} {k}")
        np.testing.assert_array_equal(
            ra["occupancy"].numpy(), np.asarray(new.grid.occupancy)[s])
        # JAX's vmapped step computes what its shards compute: its losses
        # are the mean of theirs (its parameters are not compared with
        # the shards' mean gradients applied: vmap's numerics round a
        # near-zero gradient element to the other sign, 2 lr apart)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(
                float(np.asarray(jl[k])[s]),
                np.mean([float(x[1][k]) for x in shard]), rtol=1e-5,
                err_msg=f"JAX subject {s} {k}")


# -- sharded inference --------------------------------------------------------

RES, GRID, VR, PR, H = 32, 32, 16, 32, 48
AVATAR_KW = dict(n_steps=128, k_cap=8, grid_size=GRID, eval_n_steps=48,
                 cache_n_cand=1, eval_grid="smpl_shell", shell_margin=0.08)
SNARF_KW = dict(resolution=RES, cano_pose="a_pose", n_iters=6, cand_cap=2,
                n_init_active=4)
N_BANDS = 8


def _frame_batch(yaw=0.5):
    from instantavatar_torch.data.rays import make_ray_basis
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pose = np.zeros(69, np.float32)
    pose[[45, 48]] = 0.3
    pose[[46, 49]] = 0.2
    return {"ray_basis": make_ray_basis(K, np.eye(4)),
            # per-pixel near/far, as the datasets give them (the flat
            # render reads the transform's; JAX's reads the first)
            "near": np.full(H * H, 4.0, np.float32),
            "far": np.full(H * H, 6.0, np.float32),
            "betas": np.zeros(10, np.float32), "body_pose": pose,
            "global_orient": np.array([0.0, yaw, 0.0], np.float32),
            "transl": np.array([0.0, 0.15, 5.0], np.float32)}


def _ray_patch():
    """A 16 x 16 patch of the frame's pixel rays through the body."""
    from instantavatar_torch.data.rays import make_ray_grid
    f = 2000.0 * H / 540
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    ro, rd = make_ray_grid(K, np.eye(4), H, H)
    b = _frame_batch()
    sl = (slice(16, 32), slice(16, 32))
    return {"rays_o": ro[sl].reshape(-1, 3), "rays_d": rd[sl].reshape(-1, 3),
            "near": np.full(256, 4.0, np.float32),
            "far": np.full(256, 6.0, np.float32),
            **{k: b[k] for k in ("betas", "body_pose", "global_orient",
                                 "transl")}}


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_eval_modes.py's opaque seeded avatar in both
    packages (the port's from JAX's canonical bake and shell grid), with
    JAX's frame through ``dp_render_frame`` on an 8-way ray mesh in both
    layouts and its ray patch through ``make_dp_render``."""
    from instantavatar_tpu.body import toy_smpl_model as jax_toy
    from instantavatar_tpu.deformers import SNARFDeformer as JaxSNARF
    from instantavatar_tpu.models import VoxelTriplaneField as JaxField
    from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
    from instantavatar_tpu.train import AvatarModel as JaxAvatar
    pnp = convert.seeded_field_params(VR, PR, seed=3, sigma_bias=100.0)
    jbody = jax_toy(bone_rings=3)
    jav = JaxAvatar(jbody, JaxField(voxel_res=VR, plane_res=PR),
                    JaxSNARF(jbody, **SNARF_KW), **AVATAR_KW)
    jstate = jav.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    jstate = jstate._replace(params={**jstate.params, "field":
                                     VoxelTriplaneParams(**{
                                         k: (tuple(map(jnp.asarray, v))
                                             if isinstance(v, list)
                                             else jnp.asarray(v))
                                         for k, v in pnp.items()})})
    batch = _frame_batch()
    jgrid = jav.build_pose_grid(jstate, batch)
    jmesh = jdp.make_mesh(n_ray=N_BANDS)
    jax_frames = {layout: jdp.dp_render_frame(jav, jmesh, jstate, batch,
                                              jgrid, (H, H), layout=layout)
                  for layout in ("stride", "band")}
    rays = _ray_patch()
    # JAX's make_dp_render hands ``state.params`` to ``render``, which
    # takes the field's parameters, not the state's {"field", "smpl"}
    # dict: it runs on a state that holds the field's parameters alone
    with jmesh:
        jax_rays = jdp.make_dp_render(jav, jmesh)(
            jstate._replace(params=jstate.params["field"]), _jb(rays), jgrid)
    spec = {"voxel_res": VR, "plane_res": PR, "snarf": SNARF_KW,
            "avatar": AVATAR_KW,
            "field": convert.field_params_from_numpy(pnp),
            "cano": convert.snarf_canonical_from_numpy(
                jax.tree.map(np.asarray, jstate.deformer_cano),
                device="cpu"),
            "center": torch.tensor(np.asarray(jstate.center)),
            "scale": torch.tensor(np.asarray(jstate.scale)),
            "grid": convert.grid_state_from_numpy(
                jax.tree.map(np.asarray, jgrid), device="cpu")}
    avatar, state, grid = workers.build_scene(spec)
    single = avatar.render_frame(state, batch, grid=grid, image_shape=(H, H))
    return {"spec": spec, "avatar": avatar, "state": state, "grid": grid,
            "batch": batch, "single": single, "rays": rays,
            "jax_frames": jax_frames,
            "jax_rays": {k: np.asarray(v) for k, v in jax_rays.items()}}


@pytest.mark.parametrize("layout", ["stride", "band"])
def test_dp_frame_matches_jax_and_single_device(scene, layout):
    """8 bands rendered in one process: the frame >= 40 dB from JAX's
    ``dp_render_frame`` in the same layout and within JAX's 2e-3 of the
    port's single-device frame; per-pixel sample counts equal to the
    single-device frame's; ``render_band`` gives a band's rows alone."""
    av, st, grid = scene["avatar"], scene["state"], scene["grid"]
    mesh = make_mesh(n_ray=N_BANDS)
    out = dp_render_frame(av, mesh, st, scene["batch"], grid, (H, H),
                          layout=layout)
    single = scene["single"]
    rgb = out["rgb"].numpy()
    assert rgb.shape == (H * H, 3) and np.isfinite(rgb).all()
    assert 0.05 < float(out["alpha"].mean()) < 0.95
    db = _psnr(rgb, np.asarray(scene["jax_frames"][layout]["rgb"]))
    assert db >= MIN_DB, db
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), single[k].numpy(),
                                   atol=2e-3, err_msg=k)
    assert torch.equal(out["counter"], single["counter"])
    assert out["n_samples"] == single["n_samples"]
    assert out["n_occ"] == single["n_occ"]
    # band 3 alone: its rows of the frame, in band order
    rend = DPFrameRenderer(av, mesh, layout=layout)
    band = rend.render_band(st, scene["batch"], 3, grid=grid,
                            image_shape=(H, H))
    n_loc = H * H // N_BANDS
    perm = rend._shape_frame(scene["batch"], (H, H)).perm
    rows = (np.arange(3 * n_loc, 4 * n_loc) if perm is None
            else perm[3 * n_loc:4 * n_loc])
    assert torch.equal(band["rgb"], out["rgb"][torch.as_tensor(rows)])


def test_dp_frame_turntable_bake_memo(scene):
    """``render_frames`` over a 3-frame turntable with one session: the
    first frame's first band bakes, every other band and frame reuses the
    bake; each frame is >= 40 dB from the same frame rendered with its own
    bake and from the single-device frame. (The pose's bake made under
    another global orientation differs in fp32 rounding, which Broyden's
    J_inv estimate can carry to a few 1e-3 in a pixel of this
    high-frequency field: measured 2.3e-3 in one of 6,912 values.)"""
    av, st, grid = scene["avatar"], scene["state"], scene["grid"]
    rend = DPFrameRenderer(av, make_mesh(n_ray=N_BANDS))
    frames = [_frame_batch(2 * np.pi * i / 3) for i in range(3)]
    sess = RenderSession()
    outs = list(rend.render_frames(st, frames, grid=grid, image_shape=(H, H),
                                   session=sess))
    assert [o["bands_baked"] for o in outs] == [1, 0, 0]
    assert sess.last_bake is not None
    for f, o in zip(frames, outs):
        own = rend.render_frame(st, f, grid=grid, image_shape=(H, H))
        assert own["bands_baked"] == 1
        assert _psnr(o["rgb"].numpy(), own["rgb"].numpy()) >= MIN_DB
        ref = av.render_frame(st, f, grid=grid, image_shape=(H, H))
        assert _psnr(o["rgb"].numpy(), ref["rgb"].numpy()) >= MIN_DB


def test_dp_render_rays_matches_jax(scene):
    """``make_dp_render`` on a 16 x 16 ray patch over 8 ray shards in one
    process: >= 40 dB rgb from JAX's ``make_dp_render`` and within 2e-3 of
    the port's eval render of the whole patch; counters equal."""
    av, st, grid = scene["avatar"], scene["state"], scene["grid"]
    out = make_dp_render(av, make_mesh(n_ray=N_BANDS))(st, scene["rays"],
                                                       grid)
    whole = av.render(st, scene["rays"], grid=grid, eval_mode=True)
    assert out["rgb"].shape == (256, 3) and out["alpha"].mean() > 0.05
    assert _psnr(out["rgb"].numpy(), scene["jax_rays"]["rgb"]) >= MIN_DB
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(out[k].numpy(), whole[k].numpy(),
                                   atol=2e-3, err_msg=k)
    np.testing.assert_array_equal(out["counter"].numpy(),
                                  scene["jax_rays"]["counter"])


def test_spawned_dp_render(scene, tmp_path):
    """2 spawned gloo ranks, each one band or ray shard, gathered by
    ``all_gather_into_tensor``: both ranks hold the same frame, within
    1e-5 of the same two bands rendered in one process, in both layouts;
    the ray batch likewise."""
    torch.save({"scene": scene["spec"], "frame": scene["batch"],
                "image_shape": (H, H), "rays": scene["rays"]},
               tmp_path / "inputs.pt")
    run_ranks(workers.render_rank, 2, backend="gloo", store_dir=tmp_path,
              args=(str(tmp_path),), timeout=SPAWN_TIMEOUT, threads=1)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    av, st, grid = scene["avatar"], scene["state"], scene["grid"]
    mesh = make_mesh(n_ray=2)
    for layout in ("stride", "band"):
        ref = dp_render_frame(av, mesh, st, scene["batch"], grid, (H, H),
                              layout=layout)
        for k in ("rgb", "depth", "alpha", "counter"):
            assert torch.equal(ranks[0][layout][k], ranks[1][layout][k])
            np.testing.assert_allclose(ranks[0][layout][k].numpy(),
                                       ref[k].numpy(), atol=1e-5,
                                       err_msg=f"{layout} {k}")
        assert ranks[0][layout]["n_samples"] == ref["n_samples"]
    ref = make_dp_render(av, mesh)(st, scene["rays"], grid)
    for k in ("rgb", "alpha", "counter"):
        np.testing.assert_allclose(ranks[1]["rays"][k].numpy(),
                                   ref[k].numpy(), atol=1e-5, err_msg=k)
