"""The in-the-wild demo's SMPL fit as the benchmark runs it (``avatarbench``:
the ``smpl-ngp-fit`` configuration, the ``fit`` loop), on the CPU at a
small size: 48 px capsule frames, a 4-level hash grid, 8 evaluated slots
of 32 samples a ray, the 192-vertex toy body, 2 patches of 32^2 a step.

* The port's fit steps (``AvatarModel.train_multi_step``, eager here)
  against the plain reference ``avatarbench/reference/smpl-ngp-fit.py``
  on seeded random weights, over 3 steps (one step, then a group of two)
  with one grid update: the loss terms (LPIPS and the depth term
  included), the field's and the SMPL leaves' first gradient, and both
  groups' change. Tolerances: the two run the same plain PyTorch on one
  device, but the reference inverts its 4 x 4 transforms with
  ``torch.linalg.inv`` (the port by cofactors), evaluates the field on the
  valid points only and normalises the LPIPS taps by |x| + 1e-10: terms
  1e-5 relative, first gradients 1e-4 L2-relative per leaf, the change
  1e-3 (Adam divides small gradients by their own size).
* The reference imports neither the port, the JAX package nor JAX.
* The configuration's knobs are what ``config/build.py`` builds from
  ``confs/SNARF_NGP_fitting.yaml deformer=smpl train.max_epochs=200``,
  and its traffic's frames and patches are the demo's conf's.
* The LPIPS trunk's counter counts one call a step, taken off at a
  capture and added back at each replay (on the card: through the step
  graphs, which count it beside the kernels; the kernels' counters do not
  know the losses).
* ``limits/demo-fit.json`` bounds every number the ``fit`` loop compares:
  the reference against itself passes, a program whose field or SMPL
  leaves never move does not.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from avatarbench import build, check
from avatarbench.loops import fit as fit_loop
from avatarbench.loops import train as train_loop
from instantavatar_torch.config import load_config
from instantavatar_torch.config.build import build_avatar
from instantavatar_torch.deformers import SMPLDeformer
from instantavatar_torch.kernels import COUNTED, add_replay, captured_counts
from instantavatar_torch.losses import LPIPS
from instantavatar_torch.train.step_graph import STEP_COUNTED

# the xdist workers share the cores: each worker's torch takes its share
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2147483659
POSE = ("betas", "global_orient", "body_pose", "transl")


def _load(rel: str) -> dict:
    return json.loads((REPO / rel).read_text())


def small() -> tuple[dict, dict]:
    """The configuration and traffic cut to the CPU: 3 steps in groups of
    one, then two; the grid updates at step 0."""
    cfg = _load("avatarbench/configs/smpl-ngp-fit.json")
    cfg["body"].update(ring_size=8, bone_rings=0)
    cfg["field"]["grid"].update(n_levels=4, log2_hashmap_size=12)
    cfg["widths"]["sigma_dims"] = [8, 64, 16]
    cfg["avatar"].update(n_steps=32, k_cap=8, grid_size=16)
    tr = _load("avatarbench/traffic/fit-patch.json")
    tr.update(frames=4, size=48, focal=48.0, num_patch=2, group=2)
    return cfg, tr


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def fit():
    """The port's and the reference's checked steps from one seed, and
    the LPIPS counts of the port's eager steps."""
    torch.manual_seed(0)
    cfg, tr = small()
    data = fit_loop.fit_data(cfg, tr, SEED, CPU)
    model = fit_loop.make_model(cfg, CPU, tr["frames"])
    state = model.init(data["smpl"]["betas"], smpl_params=data["smpl"])
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), SEED, CPU))
    p0 = {n: p.detach().clone() for n, p in model.field.named_parameters()}
    q0 = [t.detach().clone() for t in state.smpl]
    ds = train_loop.make_dataset(build.program_lib(), data, tr, SEED, 0)
    gen = torch.Generator().manual_seed(SEED)
    it = train_loop.groups(train_loop.frame_order(tr["frames"], SEED),
                           tr["group"], [1])
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    StepDraws = build.program_lib().train.StepDraws
    before = (LPIPS.launches, LPIPS.rows)
    parts, step, g0, pg0 = [], 0, None, None
    for _ in range(2):
        idxs = next(it)
        state, ls = model.train_multi_step(
            state, {k: torch.as_tensor(v) for k, v in
                    train_loop.host_group(ds, idxs).items()},
            train_loop.draws(model, StepDraws, gen, n_rays, step, len(idxs)))
        if step == 0:   # the one-step group: the first step's gradients
            g0 = {n: p.grad.clone() for n, p in
                  model.field.named_parameters()}
            pg0 = dict(zip(POSE, (t.grad.clone() for t in state.smpl)))
        step += len(idxs)
        parts.append({k: float(v) for k, v in ls.items()})
    counted = (LPIPS.launches - before[0], LPIPS.rows - before[1])
    prog = {"parts": parts, "g0": g0, "pose_g0": pg0,
            "delta": {n: p.detach() - p0[n] for n, p in
                      model.field.named_parameters()},
            "pose_delta": {k: t.detach() - q for k, t, q in
                           zip(POSE, state.smpl, q0)}}
    ref_mod = check.load_reference("smpl-ngp-fit")
    ref = ref_mod.fit_steps(ref_mod.make_model(cfg, CPU, tr["frames"]), cfg,
                            tr, SEED, data, CPU)
    return {"prog": prog, "ref": ref, "steps": step, "counted": counted,
            "model": model, "state": state, "tr": tr, "ds": ds}


@pytest.mark.parametrize("what", ["losses", "field_gradient",
                                  "pose_gradient", "change"])
def test_port_fit_steps_match_reference(fit, what):
    prog, ref = fit["prog"], fit["ref"]
    assert fit["steps"] == 3
    if what == "losses":
        terms = ("loss", "mse_loss", "loss_alpha", "reg_alpha",
                 "reg_density", "loss_lpips", "loss_depth_reg",
                 "reg_occupancy")
        for got, want in zip(prog["parts"], ref["parts"], strict=True):
            for k in terms:
                assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-9), k
            assert got["loss_lpips"] > 0 and got["loss_depth_reg"] > 0
        assert prog["parts"][0]["reg_occupancy"] > 0   # the grid update
    elif what == "field_gradient":
        for n, g in ref["g0"].items():
            assert _rel(prog["g0"][n], g) <= 1e-4, n
    elif what == "pose_gradient":
        for k in POSE:
            g = ref["pose_g0"][k]
            assert g.norm() > 0, k   # every leaf takes a gradient
            assert _rel(prog["pose_g0"][k], g) <= 1e-4, k
    else:
        for n, d in ref["delta"].items():
            assert _rel(prog["delta"][n], d) <= 1e-3, n
        for k in POSE:
            d = ref["pose_delta"][k]
            assert d.norm() > 0, k   # both groups moved
            assert _rel(prog["pose_delta"][k], d) <= 1e-3, k


def test_reference_imports_no_program_nor_jax():
    """A fresh interpreter that builds the reference's model and runs its
    pieces loads no module of the port, of the JAX package or of JAX."""
    code = (
        "import json, sys, torch\n"
        "from avatarbench import check\n"
        "ref = check.load_reference('smpl-ngp-fit')\n"
        "cfg = json.load(open('avatarbench/configs/smpl-ngp-fit.json'))\n"
        "cfg['body'].update(ring_size=8, bone_rings=0)\n"
        "cfg['field']['grid'].update(n_levels=4, log2_hashmap_size=12)\n"
        "cfg['widths']['sigma_dims'] = [8, 64, 16]\n"
        "m = ref.make_model(cfg, torch.device('cpu'), 4)\n"
        "x = torch.rand((1, 32, 32, 3))\n"
        "assert float(m.lpips(x, x.flip(1))[0]) > 0\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules} & "
        "{'instantavatar_torch', 'instantavatar_tpu', 'jax', 'jaxlib'})\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for path in list((REPO / "avatarbench/reference/fit").glob("*.py")) + [
            REPO / "avatarbench/reference/smpl-ngp-fit.py"]:
        text = path.read_text()
        assert "instantavatar" not in text.replace(
            "instantavatar_torch/", ""), path   # no import, no path
        assert "import jax" not in text and "from jax" not in text, path


def test_config_knobs_are_the_demo_fits():
    """The configuration's model equals what the conf builder makes of
    the demo's first command (the body aside: the configuration takes the
    7,008-vertex toy body), and the traffic's frames and patches are the
    demo's conf's."""
    conf = load_config(REPO / "confs", "SNARF_NGP_fitting",
                       ["dataset=custom/video", "deformer=smpl",
                        "train.max_epochs=200"])
    cfg, tr = (_load("avatarbench/configs/smpl-ngp-fit.json"),
               _load("avatarbench/traffic/fit-patch.json"))
    want = build_avatar(conf, steps_per_epoch=tr["frames"], device=CPU)
    got = fit_loop.make_model(cfg, CPU, tr["frames"])
    assert type(got.field) is type(want.field)
    assert got.field.grid == want.field.grid
    assert got.field.sigma_dims == want.field.sigma_dims
    assert got.field.color_dims == want.field.color_dims
    assert type(got.deformer) is type(want.deformer) is SMPLDeformer
    assert got.deformer.threshold == want.deformer.threshold == 0.05
    for k in ("n_steps", "k_cap", "grid_size", "grid_update_interval",
              "noise_steps", "optimize_smpl", "is_refine", "smpl_init",
              "train_warp_cache", "loss_weights", "_use_ngp_loss"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.optimize_smpl and got.loss_weights["w_lpips"] == 0.01
    assert got.optimizer == want.optimizer          # lr, smpl_lr, decay, ...
    assert (got.optimizer.lr, got.optimizer.smpl_lr,
            got.optimizer.max_epochs) == (1e-3, 1e-4, 200)
    assert got.lpips_fn.net == want.lpips_fn.net == "vgg"
    theirs = dict(want.lpips_fn.named_buffers())
    for n, b in got.lpips_fn.named_buffers():
        assert torch.equal(b, theirs[n]), n
    assert got.body.v_template.shape[0] == 7008
    train = conf.dataset.opt.train
    assert tr["frames"] == (train.end - train.start) // train.skip == 199
    assert train.downscale == 1 and tr["size"] == 540
    s = conf.sampler
    assert (tr["num_patch"], tr["patch_size"], tr["ratio_mask"]) == (
        s.num_patch, s.patch_size, s.ratio_mask)
    assert s.dilate == 0


def test_reference_lpips_is_the_ports():
    """The reference's trunk and heads are the port's seeded random trunk
    and shipped heads: distances and the predicted images' gradient
    agree."""
    ref = check.load_reference("smpl-ngp-fit").VGGLPIPS(CPU, seed=0)
    port = fit_loop.make_model(small()[0], CPU, 4).lpips_fn
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand((3, 32, 32, 3), generator=g) for _ in range(2))
    a1, a2 = a.clone().requires_grad_(), a.clone().requires_grad_()
    d_ref, d_port = ref(a1, b), port(a2, b)
    assert torch.allclose(d_ref, d_port, rtol=1e-5, atol=0)
    d_ref.sum().backward()
    d_port.sum().backward()
    assert _rel(a1.grad, a2.grad) <= 1e-5


def test_lpips_counter_counts_one_call_per_step_replay(fit):
    """Eager: one call and 2 x 2 x 32^2 rows a step. Under a capture
    (``captured_counts`` of ``STEP_COUNTED``, as the step graphs take it)
    one step's count is taken off the counter, and each replay
    (``add_replay``) adds it back."""
    assert fit["counted"] == (3, 3 * 2 * 2 * 32 * 32)
    model, state, ds, tr = fit["model"], fit["state"], fit["ds"], fit["tr"]
    lib = build.program_lib()
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    gen = torch.Generator().manual_seed(3)
    draws = train_loop.draws(model, lib.train.StepDraws, gen, n_rays,
                             state.step, 1)
    batch = {k: torch.as_tensor(v) for k, v in
             train_loop.host_group(ds, [0]).items()}
    before = (LPIPS.launches, LPIPS.rows)
    with captured_counts(STEP_COUNTED) as counts:
        model.train_multi_step(state, batch, draws)
    assert (LPIPS.launches, LPIPS.rows) == before
    assert counts[STEP_COUNTED.index(LPIPS)] == (1, 2 * 2 * 32 * 32)
    for _ in range(4):
        add_replay(counts, STEP_COUNTED)
    assert (LPIPS.launches - before[0], LPIPS.rows - before[1]) == (
        4, 4 * 2 * 2 * 32 * 32)


def test_step_graphs_count_lpips_beside_the_kernels():
    """The step graphs count the kernels and the LPIPS trunk; the kernels'
    counters (a fresh interpreter importing ``instantavatar_torch.kernels``)
    load no module of the losses."""
    assert STEP_COUNTED == (*COUNTED, LPIPS)
    assert LPIPS not in COUNTED
    code = ("import json, sys, instantavatar_torch.kernels\n"
            "print(json.dumps(sorted(k for k in sys.modules "
            "if k.startswith('instantavatar_torch.losses'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("program", ["reference", "field_frozen",
                                     "pose_frozen"])
def test_demo_fit_limits_bound_every_compared_number(fit, program):
    """The ``fit`` loop's compared numbers, held to ``limits/demo-fit.json``
    as the harness holds them (each at most its limit): the limits name
    every compared number; the reference's own steps read 0 and pass; a
    program whose field, or whose SMPL leaves, never moved reads a change
    gap of 1 and fails."""
    ref = fit["ref"]
    prog = dict(ref)
    key = {"field_frozen": "delta", "pose_frozen": "pose_delta"}.get(program)
    if key:
        prog[key] = {k: torch.zeros_like(v) for k, v in ref[key].items()}
    nums = fit_loop.compare(prog, ref)
    limits = _load("avatarbench/limits/demo-fit.json")
    assert set(limits) == {k for k in nums if not k.startswith("_")}
    failed = {k for k in limits if not nums[k] <= limits[k]}
    if key is None:
        assert all(nums[k] == 0 for k in limits) and not failed
    else:
        gap = "delta_gap" if key == "delta" else "pose_delta_gap"
        assert nums[gap] == pytest.approx(1.0) and failed == {gap}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with `python "
                    "-m pytest tests/test_torch_fit_bench.py -q -m cuda`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fit_step_graph_replays_count_lpips_and_knn(cuda_device):
    """On the card: the fit's captured steps (``StepGraphs``) launch the
    LPIPS trunk once and the nearest-vertex kernel once (twice on a grid
    update) per replay, and the counters say so."""
    from instantavatar_torch.kernels import nearest_vertex_cuda
    dev = cuda_device
    cfg, tr = small()
    data = fit_loop.fit_data(cfg, tr, SEED, dev)
    model = fit_loop.make_model(cfg, dev, tr["frames"])
    state = model.init(data["smpl"]["betas"], smpl_params=data["smpl"])
    lib = build.program_lib()
    ds = train_loop.make_dataset(lib, data, tr, SEED, 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2

    def steps(first, k):
        batch = {k_: torch.as_tensor(v).to(dev) for k_, v in
                 train_loop.host_group(ds, list(range(k))).items()}
        return batch, train_loop.draws(model, lib.train.StepDraws, gen,
                                       n_rays, first, k)
    state, _ = model.train_multi_step(state, *steps(0, 2))   # captures
    before = (LPIPS.launches, LPIPS.rows, nearest_vertex_cuda.launches)
    state, _ = model.train_multi_step(state, *steps(2, 3))   # replays
    torch.cuda.synchronize(dev)
    assert model.step_graphs.captures == 2
    assert (LPIPS.launches - before[0], LPIPS.rows - before[1]) == (
        3, 3 * 2 * 2 * 32 * 32)
    assert nearest_vertex_cuda.launches - before[2] == 3
