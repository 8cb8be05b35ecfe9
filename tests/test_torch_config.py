"""The port's conf tree against the JAX package: the YAML reader against
PyYAML on every file of ``confs/`` and on single scalars, the emitter read
back by PyYAML, ``load_config`` against JAX's on the four top-level
configs (with and without the CLI test's overrides), the builder's knobs
against JAX's ``build_avatar`` (the NGP field, the refine, fitting and
demo configs, the SMPL deformer, smpl_init and LPIPS included), and the
options the port does not have."""
from pathlib import Path

import pytest
import yaml

from instantavatar_tpu.config import load_config as jax_load_config
from instantavatar_torch.config import instantiate, load_config, to_yaml
from instantavatar_torch.config.build import (build_avatar,
                                              build_datamodule, check_ported)
from instantavatar_torch.config.yaml_lite import (YAMLError, safe_dump,
                                                  safe_load)
from instantavatar_torch.data import PatchSampler

REPO = Path(__file__).resolve().parents[1]
CONFS = REPO / "confs"
CONF_FILES = sorted(p.relative_to(CONFS).as_posix()
                    for p in CONFS.rglob("*.yaml"))
TOP = ["SNARF_NGP", "SNARF_NGP_refine", "SNARF_NGP_fitting", "demo"]
# tests/test_cli_pipeline.py:33-49, with its sequence and run dirs
PIPELINE = [
    "dataset.opt.dataroot=/data/seq", "run_dir=/runs/run",
    "network=voxel_triplane",
    "network.opt.voxel_res=8", "network.opt.voxel_feats=4",
    "network.opt.plane_res=16", "network.opt.plane_feats=4",
    "deformer.opt.resolution=32", "deformer.opt.cano_pose=da_pose",
    "renderer.MAX_SAMPLES=32", "renderer.k_cap=8",
    "renderer.grid_size=16",
    "dataset.opt.train.start=0", "dataset.opt.train.end=2",
    "dataset.opt.train.skip=1", "dataset.opt.train.downscale=1",
    "dataset.opt.val.start=0", "dataset.opt.val.end=0",
    "dataset.opt.val.skip=1", "dataset.opt.val.downscale=1",
    "dataset.opt.test.start=1", "dataset.opt.test.end=2",
    "dataset.opt.test.skip=1", "dataset.opt.test.downscale=1",
]


@pytest.mark.parametrize("name", CONF_FILES)
def test_yaml_reader_matches_pyyaml_on_confs(name):
    """Every conf file reads as PyYAML's safe_load reads it, and the
    emitter's text of it reads back equal in both readers."""
    text = (CONFS / name).read_text()
    data = yaml.safe_load(text)
    assert safe_load(text) == data
    assert yaml.safe_load(safe_dump(data)) == data
    assert safe_load(safe_dump(data)) == data


@pytest.mark.parametrize("text", [
    "1e-2", "1e-15", "1.0e-2", "-0.5e+3", "1.5e3", ".5", "0.", "+.inf",
    "-.INF", "yes", "On", "OFF", "True", "010", "08", "0x1F", "0b101",
    "1_000", "1:30", "1:30.5", "-3", "+7", "0", "~", "null", "", "a_pose",
    "'quoted'", "'it''s'", '"a\\tb\\u00e9"', "[0.9, 0.99]", "[0, -0.3, 0]",
    "[1, [2, a], {b: c}]", "{a: 1, b: [x, y]}", "{}", "[]",
    "/tmp/x/${dataset.subject}", "subj_a,subj_b", "x:y", "abc def",
    "outputs/${dataset.name}/${experiment}", "key: value"])
def test_yaml_scalars_resolve_as_pyyaml(text):
    """Plain scalars follow PyYAML's YAML 1.1 resolver (``1e-2`` is a
    string, ``010`` octal, ``1:30`` sexagesimal), type included."""
    want, got = yaml.safe_load(text), safe_load(text)
    assert got == want and type(got) is type(want)


def test_yaml_outside_the_subset_raises():
    for text in ("a: &x 1", "a: !!str 1", "a: |\n  b", "a: b\n  c",
                 "[a, b", "d: 2020-01-01", "<<: {a: 1}"):
        with pytest.raises(YAMLError):
            safe_load(text)


@pytest.mark.parametrize("overrides", [[], PIPELINE],
                         ids=["defaults", "pipeline"])
@pytest.mark.parametrize("name", TOP)
def test_load_config_matches_jax(name, overrides):
    """The composed config equals JAX's, and its YAML reads back equal."""
    cfg = load_config(CONFS, name, overrides)
    assert cfg == jax_load_config(CONFS, name, overrides)
    assert yaml.safe_load(to_yaml(cfg)) == cfg
    assert cfg.model.opt.optimizer.lr == 1e-2 or name.endswith("fitting")


def test_builder_knobs_match_jax(monkeypatch):
    """build_avatar reads the same knobs from a config as JAX's: renderer,
    loss weights, optimizer (JAX's make_optimizer arguments captured),
    field widths, deformer settings."""
    import instantavatar_tpu.train.optim as jax_optim
    from instantavatar_tpu.config.build import build_avatar as jax_build
    over = PIPELINE + ["renderer.MAX_SAMPLES=48", "renderer.grid_size=24",
                       "model.opt.loss.opt.w_alpha=0.25",
                       "model.opt.optimizer.betas=[0.8,0.95]",
                       "deformer.opt.n_init_active=3",
                       "deformer.opt.cand_cap=2"]
    cfg = load_config(CONFS, "SNARF_NGP", over)
    seen = {}
    real = jax_optim.make_optimizer

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(jax_optim, "make_optimizer", spy)
    jav = jax_build(cfg, steps_per_epoch=7)
    av = build_avatar(cfg, steps_per_epoch=7, device="cpu")
    for k in ("n_steps", "k_cap", "grid_size", "train_warp_cache"):
        assert getattr(av, k) == getattr(jav, k), k
    assert av.loss_weights == jav.loss_weights
    spec = av.optimizer
    assert (spec.lr, spec.max_epochs, spec.steps_per_epoch, spec.betas,
            spec.eps) == (seen["lr"], seen["max_epochs"],
                          seen["steps_per_epoch"], seen["betas"],
                          seen["eps"])
    assert seen["smpl_lr"] is None and not seen["freeze_field"]
    for k in ("voxel_res", "voxel_feats", "plane_res", "plane_feats"):
        assert getattr(av.field, k) == getattr(jav.field, k), k
    for k in ("resolution", "cano_pose", "n_init_active", "cand_cap",
              "version", "n_iters"):
        assert getattr(av.deformer, k) == getattr(jav.deformer, k), k


@pytest.mark.parametrize("name,over,what", [
    ("SNARF_NGP", ["network=triplane"], "network=triplane"),
    ("SNARF_NGP", ["network=mlp"], "network=mlp"),
], ids=["SNARF_NGP-over1-triplane", "SNARF_NGP-over2-mlp"])
def test_unported_options_raise(name, over, what):
    """Each option the port lacks stops the build with the ROADMAP item
    that ports it, before anything is built."""
    cfg = load_config(CONFS, name, over)
    with pytest.raises(NotImplementedError, match=what) as e:
        check_ported(cfg)
    assert "ROADMAP.md open item" in str(e.value)
    with pytest.raises(NotImplementedError, match=what):
        build_avatar(cfg, device="cpu")


@pytest.mark.parametrize("name,over", [
    ("SNARF_NGP", []),
    ("SNARF_NGP_refine", PIPELINE),
    ("SNARF_NGP_fitting", PIPELINE + ["model.opt.loss.opt.w_lpips=0"]),
    pytest.param("SNARF_NGP", ["network=voxel_triplane", "deformer=smpl"],
                 id="SNARF_NGP-over3-SMPLDeformer"),
    pytest.param("SNARF_NGP_fitting", [], id="SNARF_NGP_fitting-w_lpips"),
    pytest.param("demo", ["network=voxel_triplane"],
                 id="demo-over6-smpl_init"),
    pytest.param("SNARF_NGP", ["network=voxel_triplane",
                               "model.opt.loss.opt.w_lpips=0.1"],
                 id="SNARF_NGP-over7-w_lpips"),
    pytest.param("SNARF_NGP_fitting", ["deformer=smpl"],
                 id="SNARF_NGP_fitting-deformer_smpl"),
    pytest.param("demo", [], id="demo-defaults"),
])
def test_ngp_and_smpl_configs_build_as_jax(monkeypatch, name, over):
    """The confs' default network, the refine, fitting and demo configs,
    and the SMPL deformer, smpl_init and LPIPS options build: the field
    class and widths, optimize_smpl / is_refine, the SMPL learning rate
    and the frozen field, the loss weights and the LPIPS module (its
    presence and net), smpl_init and the grid-update interval it forces,
    the deformer class and its threshold or version, and the noise, as
    JAX's ``build_avatar`` builds them."""
    import instantavatar_tpu.train.optim as jax_optim
    from instantavatar_tpu.config.build import build_avatar as jax_build
    cfg = load_config(CONFS, name, over)
    check_ported(cfg)
    seen = {}
    real = jax_optim.make_optimizer

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(jax_optim, "make_optimizer", spy)
    jav = jax_build(cfg, steps_per_epoch=7)
    av = build_avatar(cfg, steps_per_epoch=7, device="cpu")
    assert type(av.field).__name__ == type(jav.field).__name__
    if name == "SNARF_NGP" and not over:
        assert av.field.grid == tuple(jav.field.grid)
        assert av.field.table.shape == (16, 2 ** 19, 2)
        assert av.field.sigma_dims == jav.field.sigma_dims
    for k in ("optimize_smpl", "is_refine", "noise_steps", "loss_weights",
              "_use_ngp_loss", "smpl_init", "grid_update_interval"):
        assert getattr(av, k) == getattr(jav, k), k
    assert (av.lpips_fn is None) == (jav.lpips_fn is None)
    if av.lpips_fn is not None:
        assert av.lpips_fn.net == jav.lpips_fn.net == "vgg"
        assert not av.lpips_fn.numerically_matched
    spec = av.optimizer
    assert (spec.lr, spec.smpl_lr, spec.freeze_field) == (
        seen["lr"], seen["smpl_lr"], seen["freeze_field"])
    assert type(av.deformer).__name__ == type(jav.deformer).__name__
    if "deformer=smpl" in over:
        assert av.deformer.threshold == jav.deformer.threshold == 0.05
    else:
        assert av.deformer.version == jav.deformer.version
        assert (av.deformer.version == 2) == name.endswith("fitting")
    assert av.smpl_init == (name == "demo")


def test_native_loader_and_unknown_targets_raise():
    """dataset.opt.native=true raises before any file is read; targets in
    the JAX package resolve to the port's module of the same path, and one
    the port lacks raises ImportError naming it."""
    cfg = load_config(CONFS, "SNARF_NGP", PIPELINE + [
        "network=voxel_triplane", "+dataset.opt.native=true"])
    with pytest.raises(NotImplementedError, match="native"):
        build_datamodule(cfg)
    sampler = instantiate(cfg.dataset.opt.train.sampler)
    assert isinstance(sampler, PatchSampler)
    assert (sampler.n, sampler.patch_size, sampler.p) == (4, 32, 1)
    with pytest.raises(ImportError, match="instantavatar_tpu.data.Mocap"):
        instantiate({"_target_": "instantavatar_tpu.data.MocapDataset"})
