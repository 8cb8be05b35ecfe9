"""The port's in-the-wild preprocessing against the JAX package's scripts,
run in process (loaded by path, ``sys.argv`` set, patched only here):
``outer_contours`` against ``cv2.findContours`` point for point, the mask
reader against ``cv2.imread``, the refinement's gradients (JAX's script
with ``optax.adam`` swapped for SGD at lr 1, so that its output is its
gradient) and its ``poses_optimized.npz`` end to end, the SMPL overlay
pixel for pixel, the orchestrator's stages, the LPIPS head extractor
against the torch-free reader, and the ``bash/torch/`` wrappers' configs
against the JAX wrappers' (each at 48-64 px, at most 4 frames)."""
import importlib.util
import shlex
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from instantavatar_torch.body.toy import write_toy_smpl_npz
from instantavatar_torch.preprocess import (extract_lpips_heads,
                                            process_sequence, refine_smpl,
                                            visualize_smpl)
from instantavatar_torch.preprocess.masks import (contour_samples,
                                                  outer_contours, read_mask)
from instantavatar_torch.utils.image_io import read_png, write_png

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load_script(rel: str):
    """A script of the repository as a module (its ``main`` not run)."""
    path = REPO / rel
    name = "jax_script_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(monkeypatch, rel: str, args: list[str]) -> None:
    monkeypatch.setattr(sys, "argv", [rel, *args])
    _load_script(rel).main()


# -- masks and contours --------------------------------------------------------

def _cv2_contours(mask):
    cv2 = pytest.importorskip("cv2")
    cs, _ = cv2.findContours((mask > 0.5).astype(np.uint8), cv2.RETR_EXTERNAL,
                             cv2.CHAIN_APPROX_NONE)
    return [c.reshape(-1, 2) for c in cs]


def _assert_contours_match(mask):
    ref = _cv2_contours(mask)
    got = outer_contours(mask)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _named_masks():
    def m(h, w):
        return np.zeros((h, w), np.float32)
    one = m(5, 5)
    one[2, 2] = 1
    hline, vline = m(6, 9), m(9, 6)
    hline[3, 1:8] = 1
    vline[1:8, 3] = 1
    diag = np.eye(7, dtype=np.float32)
    anti = np.fliplr(np.eye(7, dtype=np.float32)).copy()
    ring = m(12, 12)
    ring[2:10, 2:10] = 1
    ring[4:8, 4:8] = 0
    nested = ring.copy()
    nested[5:7, 5:7] = 1           # a blob inside the ring's hole
    edges = m(10, 12)
    edges[0, 3:6] = 1              # top
    edges[4:7, 0] = 1              # left
    edges[9, 5:10] = 1             # bottom
    edges[2:8, 11] = 1             # right
    full = np.ones((6, 7), np.float32)
    several = m(16, 16)
    for y, x, s in ((1, 1, 3), (1, 8, 2), (6, 3, 4), (11, 10, 4), (7, 12, 1)):
        several[y:y + s, x:x + s] = 1
    c_shape = m(10, 10)
    c_shape[1:9, 1:8] = 1
    c_shape[3:7, 4:8] = 0
    c_shape[4:6, 6] = 1            # a blob in the C's open mouth
    touch = m(6, 6)
    touch[1, 1] = touch[2, 2] = touch[2, 4] = touch[3, 3] = 1
    return {"one_pixel": one, "hline": hline, "vline": vline,
            "diagonal": diag, "anti_diagonal": anti, "ring_with_hole": ring,
            "blob_in_hole": nested, "touching_edges": edges, "full": full,
            "several_blobs": several, "c_shape": c_shape,
            "diagonal_touch": touch, "empty": m(8, 8)}


NAMED = _named_masks()


@pytest.mark.parametrize("name", sorted(NAMED))
def test_outer_contours_match_cv2_named(name):
    """Each named mask's outer borders equal cv2's, point for point and in
    cv2's order."""
    _assert_contours_match(NAMED[name])


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.integers(1, 24), st.integers(1, 24), st.integers(0, 2 ** 32 - 1),
       st.floats(0.05, 0.95))
def test_outer_contours_match_cv2_drawn(h, w, seed, density):
    """Random masks up to 24 x 24 (any density, so holes, nesting and
    8-connected chains occur) against cv2."""
    mask = (np.random.default_rng(seed).random((h, w)) < density)
    _assert_contours_match(mask.astype(np.float64))


@pytest.mark.parametrize("name", ["several_blobs", "ring_with_hole", "empty"])
def test_contour_samples_match_jax_script(name):
    """The silhouette stage's sample: the JAX script's concatenation and
    linspace pick over cv2's contours (a single (0, 0) without any)."""
    ref = _cv2_contours(NAMED[name])
    pts = np.concatenate(ref) if ref else np.zeros((1, 2))
    sel = np.linspace(0, len(pts) - 1, 512).astype(int)
    got = contour_samples(NAMED[name])
    assert got.dtype == np.float32 and got.shape == (512, 2)
    np.testing.assert_array_equal(got, pts[sel].astype(np.float32))


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "npy"])
def test_read_mask_matches_cv2(tmp_path, kind):
    """``read_mask`` equals ``cv2.imread(..., IMREAD_GRAYSCALE) / 255.0``
    on gray and colour PNGs (libpng's fixed-point gray rule), and
    ``np.load`` on ``.npy``."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    if kind == "npy":
        arr = rng.random((48, 52)).astype(np.float32)
        np.save(tmp_path / "m.npy", arr)
        np.testing.assert_array_equal(read_mask(tmp_path / "m.npy"), arr)
        return
    shape = {"gray": (48, 52), "bgr": (48, 52, 3), "bgra": (48, 52, 4)}[kind]
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    f = str(tmp_path / "m.png")
    cv2.imwrite(f, img)
    ref = cv2.imread(f, cv2.IMREAD_GRAYSCALE) / 255.0
    got = read_mask(f)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# -- refinement -------------------------------------------------------------

def _write_sequence(root: Path, n_frames: int = 4, layout: str = "split",
                    masks: str = "npy", sigma: float = 0.05) -> Path:
    """JAX's synthetic sequence with GT keypoints (conf 1 on the body's
    slots) and poses perturbed from GT as ROMP would leave them
    (transl, global_orient and body_pose, ``sigma``)."""
    from instantavatar_tpu.body import smpl_forward, toy_smpl_model
    from instantavatar_tpu.body.extra_joints import body25_keypoints_or_core
    from instantavatar_tpu.data import make_synthetic_sequence
    seq = make_synthetic_sequence(root, n_frames=n_frames, H=64, W=64)
    raw = dict(np.load(seq / "poses.npz"))
    K = np.load(seq / "cameras.npz")["intrinsic"]
    out = smpl_forward(toy_smpl_model(), *(jnp.asarray(raw[k]) for k in (
        "betas", "body_pose", "global_orient", "transl")))
    j, slots = body25_keypoints_or_core(out.joints, out.vertices)
    p = np.asarray(j) @ K.T
    kp = np.zeros((n_frames, 25, 3), np.float32)
    kp[:, slots, :2] = p[..., :2] / p[..., 2:3]
    kp[:, slots, 2] = 1.0
    np.save(seq / "keypoints.npy", kp)
    rng = np.random.default_rng(0)
    for k in ("transl", "global_orient", "body_pose"):
        raw[k] = (raw[k] + sigma * rng.standard_normal(raw[k].shape)
                  ).astype(np.float32)
    if layout == "thetas":
        raw["thetas"] = np.concatenate([raw.pop("global_orient"),
                                        raw.pop("body_pose")], axis=-1)
    np.savez(seq / "poses.npz", **raw)
    if masks == "png":     # gray PNGs, as SAM and RVM write them
        for f in sorted((seq / "masks").glob("*.npy")):
            write_png(f.with_suffix(".png"),
                      (np.load(f) * 255).astype(np.uint8))
            f.unlink()
    return seq


def _body_args(seq: Path, body: str) -> list[str]:
    """``--smpl-path`` for the toy fallback (192 vertices, core slots) or a
    7,008-vertex toy body written as a model file (the 25 BODY25 slots)."""
    if body == "fallback":
        return ["--smpl-path", str(seq / "no_model_here")]
    write_toy_smpl_npz(seq / "SMPL_NEUTRAL.npz", ring_size=16, bone_rings=18)
    return ["--smpl-path", str(seq)]


@pytest.mark.parametrize("stage", ["keypoint", "silhouette"])
@pytest.mark.parametrize("body", ["fallback", "model_file"])
def test_refine_gradients_match_jax_script(tmp_path, monkeypatch, stage,
                                           body):
    """One step of JAX's script with Adam swapped for SGD at lr 1 gives
    its gradient (start - output); the port's gradient of the same loss
    agrees within 1e-4 L2-relative per leaf (body_pose columns 0-59: the
    script zeroes the rest of its output)."""
    import optax
    seq = _write_sequence(tmp_path / "seq", layout="thetas")
    body_args = _body_args(seq, body)
    args = ["--data-dir", str(seq), *body_args]
    args += (["--iters", "1"] if stage == "keypoint"
             else ["--iters", "0", "--silhouette", "--sil-iters", "1"])
    monkeypatch.setattr(optax, "adam", lambda lr: optax.sgd(1.0))
    _run_script(monkeypatch, "scripts/custom/refine_smpl.py", args)
    stepped = dict(np.load(seq / "poses_optimized.npz"))

    model = refine_smpl.load_model(body_args[1], "neutral", CPU)
    assert model.num_verts == (192 if body == "fallback" else 7008)
    start = refine_smpl.load_poses(seq / "poses.npz", CPU)
    K = torch.as_tensor(np.load(seq / "cameras.npz")["intrinsic"],
                        dtype=torch.float32)
    kp = torch.as_tensor(np.load(seq / "keypoints.npy"))
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    loss = refine_smpl.keypoint_loss(model, params, K, kp, 0.1)
    if stage == "silhouette":
        contours = torch.as_tensor(refine_smpl.mask_contours(seq / "masks"))
        loss = loss + refine_smpl.silhouette_loss(model, params, K, contours)
    loss.backward()
    for k in refine_smpl.KEYS:
        g_jax = start[k].numpy() - stepped[k]
        g = params[k].grad.numpy()
        if k == "body_pose":
            g_jax, g = g_jax[:, :60], g[:, :60]
        rel = np.linalg.norm(g - g_jax) / np.linalg.norm(g_jax)
        assert rel < 1e-4, (k, rel)


@pytest.mark.parametrize("layout,masks", [("split", "npy"),
                                          ("thetas", "npy"),
                                          ("thetas", "png")])
def test_refine_end_to_end_matches_jax_script(tmp_path, monkeypatch, layout,
                                              masks):
    """20 keypoint + 10 silhouette iterations: the port's
    ``poses_optimized.npz`` is within 1e-3 of the JAX script's, with the
    same keys, shapes and zeroed pose tail."""
    seq = _write_sequence(tmp_path / "seq", layout=layout, masks=masks)
    args = ["--data-dir", str(seq), "--smpl-path", str(tmp_path / "none"),
            "--silhouette", "--iters", "20", "--sil-iters", "10"]
    _run_script(monkeypatch, "scripts/custom/refine_smpl.py", args)
    ref = dict(np.load(seq / "poses_optimized.npz"))
    path = refine_smpl.main([*args, "--device", "cpu"])
    got = dict(np.load(path))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3)
    assert not got["body_pose"][:, 60:].any()


def test_refine_recovers_translation(tmp_path):
    """The port's counterpart of JAX's recovery test: keypoints from GT
    poses, the stored transl perturbed; the refined transl error is under
    half the start's."""
    seq = _write_sequence(tmp_path / "seq", n_frames=3, sigma=0.0)
    raw = dict(np.load(seq / "poses.npz"))
    gt = raw["transl"].copy()
    rng = np.random.RandomState(0)
    raw["transl"] = raw["transl"] + 0.15 * rng.randn(3, 3).astype(np.float32)
    np.savez(seq / "poses.npz", **raw)
    err0 = np.abs(raw["transl"] - gt).mean()
    refine_smpl.main(["--data-dir", str(seq), "--smpl-path", "/nonexistent",
                      "--iters", "150", "--lr", "0.02", "--w-temporal", "0",
                      "--device", "cpu"])
    opt = np.load(seq / "poses_optimized.npz")
    err1 = np.abs(opt["transl"] - gt).mean()
    assert err1 < 0.5 * err0, (err0, err1)


# -- the overlay ----------------------------------------------------------------

@pytest.mark.parametrize("poses", ["optimized", "raw"])
def test_overlay_matches_jax_script(tmp_path, monkeypatch, poses):
    """The decoded overlay PNGs equal the JAX script's exactly (its model
    loader patched to the toy body; the port reads the toy body from a
    model file), from ``poses_optimized.npz`` when present, else
    ``poses.npz`` (``thetas``)."""
    import instantavatar_tpu.body as jax_body
    seq = _write_sequence(tmp_path / "seq", layout="thetas")
    if poses == "optimized":
        raw = dict(np.load(seq / "poses.npz"))
        th = raw.pop("thetas")
        np.savez(seq / "poses_optimized.npz", global_orient=th[:, :3] + 0.1,
                 body_pose=th[:, 3:], betas=raw["betas"],
                 transl=raw["transl"])
    monkeypatch.setattr(jax_body, "load_smpl_model",
                        lambda *a, **k: jax_body.toy_smpl_model())
    _run_script(monkeypatch, "scripts/visualize_smpl.py",
                ["--data-dir", str(seq)])
    ref = {f.name: read_png(f) for f in (seq / "smpl_overlay").glob("*.png")}
    for f in (seq / "smpl_overlay").glob("*.png"):
        f.unlink()
    write_toy_smpl_npz(tmp_path / "SMPL_NEUTRAL.npz")
    n = visualize_smpl.main(["--data-dir", str(seq), "--smpl-path",
                             str(tmp_path), "--device", "cpu"])
    assert n == 4 and len(ref) == 4
    for name, img in ref.items():
        got = read_png(seq / "smpl_overlay" / name)
        np.testing.assert_array_equal(got, img)
    assert (np.all(got == (0, 255, 0), axis=-1)).sum() > 20


def test_overlay_needs_a_model_file(tmp_path):
    """No toy fallback in the overlay stage: a missing model raises."""
    seq = _write_sequence(tmp_path / "seq")
    with pytest.raises(FileNotFoundError):
        visualize_smpl.main(["--data-dir", str(seq), "--smpl-path",
                             str(tmp_path / "none"), "--device", "cpu"])


# -- the orchestrator ---------------------------------------------------------------

# the JAX scripts (under scripts/) that the port's module stages replace
PORTED_STAGES = {"refine_smpl": "custom/refine_smpl.py",
                 "visualize_smpl": "visualize_smpl.py"}


def _stage(cmd: list[str]) -> tuple[str, list[str]]:
    """(script under ``scripts/``, arguments) of one stage's command line;
    the port's module stages by the script they replace, without
    ``--device``."""
    assert cmd[0] == sys.executable
    if cmd[1] == "-m":
        args = list(cmd[3:])
        i = args.index("--device")
        assert args[i + 1] == "cpu"
        del args[i:i + 2]
        return PORTED_STAGES[cmd[2].removeprefix(
            "instantavatar_torch.preprocess.")], args
    return Path(cmd[1]).resolve().relative_to(REPO / "scripts").as_posix(), \
        cmd[2:]


@pytest.mark.parametrize("present,extra", [
    ((), []),
    (("keypoints.npy",), []),
    (("poses.npz",), ["--openpose-bin", "/opt/openpose"]),
    (("keypoints.npy", "poses.npz"), ["--sam-checkpoint", "sam.pth"]),
    (("keypoints.npy", "poses.npz"), ["--smpl-path", "models/smpl"]),
])
def test_orchestrator_stages_match_jax(tmp_path, monkeypatch, present,
                                       extra):
    """Under a stubbed ``subprocess.run``, the port's orchestrator runs the
    JAX orchestrator's stages, in its order, with its arguments: the
    external-model scripts by the same path, refine and the overlay as
    the port's modules (``--device`` passed on)."""
    root = tmp_path / "seq"
    root.mkdir()
    for name in present:
        (root / name).write_bytes(b"")
    calls = []

    def fake_run(cmd, check=False, **kw):
        assert check
        calls.append([str(c) for c in cmd])
        return subprocess.CompletedProcess(cmd, 0)
    monkeypatch.setattr(subprocess, "run", fake_run)
    _run_script(monkeypatch, "scripts/custom/process_sequence.py",
                ["--data-dir", str(root), *extra])
    ref, calls[:] = [_stage(c) for c in calls], []
    process_sequence.main(["--data-dir", str(root), *extra,
                           "--device", "cpu"])
    assert [_stage(c) for c in calls] == ref
    assert calls[-2][1:3] == ["-m", "instantavatar_torch.preprocess."
                                    "refine_smpl"]


# -- the LPIPS head extractor -----------------------------------------------

@pytest.mark.parametrize("zip_format", [True, False])
def test_lpips_heads_match_torch_reader(tmp_path, zip_format):
    """The port's heads, read with ``torch.load(weights_only=True)``, equal
    the JAX package's torch-free reader on the same ``.pth`` (the zip
    format and the legacy one the upstream files use)."""
    from instantavatar_tpu.utils.torch_reader import load_torch_weights
    widths = {"vgg": (64, 128, 256, 512, 512), "alex": (64, 192, 384, 256, 256)}
    g = torch.Generator().manual_seed(0)
    for net, cs in widths.items():
        sd = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
              for i, c in enumerate(cs)}
        torch.save(sd, tmp_path / f"{net}.pth",
                   _use_new_zipfile_serialization=zip_format)
    out = extract_lpips_heads.main([str(tmp_path), "--out-dir",
                                    str(tmp_path / "out")])
    assert [p.name for p in out] == ["lpips_heads_vgg.npz",
                                     "lpips_heads_alex.npz"]
    for net, cs in widths.items():
        ref = load_torch_weights(str(tmp_path / f"{net}.pth"))
        got = np.load(tmp_path / "out" / f"lpips_heads_{net}.npz")
        assert sorted(got.files) == [f"head{i}" for i in range(5)]
        for i, c in enumerate(cs):
            want = np.asarray(ref[f"lin{i}.model.1.weight"],
                              np.float32).reshape(-1)
            assert got[f"head{i}"].dtype == np.float32
            np.testing.assert_array_equal(got[f"head{i}"], want)


# -- the bash wrappers ---------------------------------------------------------

DEFAULTS = {"train": "SNARF_NGP", "eval": "SNARF_NGP_refine",
            "fit": "SNARF_NGP_fitting", "animate": "SNARF_NGP",
            "novel_view": "SNARF_NGP"}
WRAPPERS = ["run-demo.sh", "run-neuman-demo.sh", "run-peoplesnapshot.sh"]


def _commands(path: Path) -> list[list[str]]:
    """The ``python`` command lines of a wrapper, with its loop's or its
    argument's default values substituted."""
    text = path.read_text().replace("\\\n", " ")
    values = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(("SUBJECT=", "SEQUENCE=")):
            var, val = line.split("=", 1)
            values[var] = [val.split(":-", 1)[1].rstrip("}")]
        elif line.startswith("for "):
            var, rest = line[4:].split(" in ", 1)
            values[var] = rest.split(";")[0].split()
    (var, vals), = values.items()
    body = [line.strip() for line in text.splitlines()
            if line.strip().startswith("python ")]
    return [shlex.split(line.replace(f"${var}", v))
            for v in vals for line in body]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_resolve_to_jax_configs(name):
    """Each line of ``bash/torch/<name>`` runs the port's counterpart of the
    matching line of ``bash/<name>`` with the same arguments, and the
    port's ``parse_cli`` resolves it to the config JAX's resolves."""
    from instantavatar_tpu.utils.cli import parse_cli as jax_parse_cli
    from instantavatar_torch.utils.cli import parse_cli
    ours = _commands(REPO / "bash" / "torch" / name)
    theirs = _commands(REPO / "bash" / name)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a[:2] == ["python", "-m"] and b[0] == "python"
        cli = a[2].removeprefix("instantavatar_torch.cli.")
        assert b[1] == f"cli/{cli}.py" and a[3:] == b[2:]
        cfg = parse_cli(a[3:], default_config=DEFAULTS[cli])
        ref = jax_parse_cli(b[2:], default_config=DEFAULTS[cli])
        assert cfg == ref


# -- the device rule and the fitting split -------------------------------------

@pytest.mark.parametrize("module", [refine_smpl, visualize_smpl,
                                    process_sequence])
def test_entry_points_need_cuda_or_cpu(tmp_path, monkeypatch, module):
    """Without a GPU and without ``--device cpu``, each entry point stops
    with a message before it reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main(["--data-dir", str(tmp_path / "missing")])


def test_fitting_split_reads_poses_optimized(tmp_path):
    """The fitting split starts from the refinement's output (range-sliced)
    when there is one, else from ``poses.npz`` as in the JAX package."""
    from instantavatar_tpu.data import AvatarDataset as JaxDataset
    from instantavatar_torch.data import AvatarDataset
    seq = _write_sequence(tmp_path / "seq", layout="thetas")
    kw = dict(start=1, end=2, fitting=True)
    ref = JaxDataset(seq, "train", **kw).smpl_params
    got = AvatarDataset(seq, "train", native=False, **kw).smpl_params
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    refine_smpl.main(["--data-dir", str(seq), "--smpl-path", "/nonexistent",
                      "--iters", "2", "--device", "cpu"])
    opt = dict(np.load(seq / "poses_optimized.npz"))
    got = AvatarDataset(seq, "train", native=False, **kw).smpl_params
    for k in opt:
        np.testing.assert_array_equal(
            got[k], opt[k] if k == "betas" else opt[k][1:3])


def test_preprocessing_runs_without_jax_or_cv2(tmp_path):
    """In a fresh interpreter with jax, optax, cv2, the JAX package and the
    image libraries blocked: refine (keypoint and silhouette, PNG masks),
    the overlay and the head extractor run, and the orchestrator
    imports."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "optax", "cv2", "instantavatar_tpu", "yaml",
          "PIL", "imageio"):
    sys.modules[m] = None
import numpy as np, torch
from instantavatar_torch.body import smpl_forward, toy_smpl_model
from instantavatar_torch.body.toy import write_toy_smpl_npz
from instantavatar_torch.data import make_synthetic_sequence
from instantavatar_torch.preprocess import (extract_lpips_heads,
                                            process_sequence, refine_smpl,
                                            visualize_smpl)
from instantavatar_torch.utils.image_io import write_png
seq = make_synthetic_sequence({str(tmp_path / 'seq')!r}, n_frames=2, H=48,
                              W=48, device="cpu")
for i in range(2):
    m = np.load(seq / f"masks/{{i:04d}}.npy")
    write_png(seq / f"masks/{{i:04d}}.png", (m * 255).astype(np.uint8))
    (seq / f"masks/{{i:04d}}.npy").unlink()
np.save(seq / "keypoints.npy", np.zeros((2, 25, 3), np.float32))
write_toy_smpl_npz(seq / "SMPL_NEUTRAL.npz")
refine_smpl.main(["--data-dir", str(seq), "--smpl-path", str(seq),
                  "--iters", "2", "--silhouette", "--sil-iters", "2",
                  "--device", "cpu"])
assert visualize_smpl.main(["--data-dir", str(seq), "--smpl-path",
                            str(seq), "--device", "cpu"]) == 2
torch.save({{f"lin{{i}}.model.1.weight": torch.ones(1, 4, 1, 1)
            for i in range(5)}}, {str(tmp_path / 'vgg.pth')!r})
assert len(extract_lpips_heads.main([{str(tmp_path)!r}, "--out-dir",
                                     {str(tmp_path / 'heads')!r}])) == 1
print("PREPROCESSING OK")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PREPROCESSING OK" in res.stdout
