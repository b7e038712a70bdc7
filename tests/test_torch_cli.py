"""The port's CLIs (`bdm_tpu_torch.main`, `main_blending`, `main_merging`,
`evaluation.cli`) on the CPU, and the BDM-Blending CLI held to
`bdm_tpu.main_blending` on the same tiny weights and keys.

Tolerances: the port's BDM-Blending CLI writes clouds within 1e-3 absolute
of the JAX CLI's (the tolerance of
`test_torch_samplers.py::test_bdm_blending_tiny_matches_jax`: eight
float32 denoise steps summed in another order), and the ground-truth
`.ply` files byte for byte.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import bdm_tpu.cli as jax_cli
import bdm_tpu.main_blending as jax_mb
from bdm_tpu.config import parse_cli as jax_parse_cli
from bdm_tpu.samplers import PC2Model as JaxPC2
from bdm_tpu.samplers import PVDModel as JaxPVD
import bdm_tpu_torch.cli as cli
import bdm_tpu_torch.evaluation.cli as eval_cli
import bdm_tpu_torch.main as mmain
import bdm_tpu_torch.main_blending as mb
import bdm_tpu_torch.main_merging as mm
from bdm_tpu_torch.config import parse_cli
from bdm_tpu_torch.samplers import BDMMergingModel, PC2Model, PVDModel
from bdm_tpu_torch.utils import convert_jax as CJ
from bdm_tpu_torch.utils import read_ply
from tests.test_models import TINY_FP, TINY_SA
from tests.test_torch_samplers import JaxKeyNoise, _init, _visible_head

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

MILESTONES = [8, 7, 5, 3, 0]
BASE_ARGS = [
    "dataset=synthetic", "dataset.image_size=16", "dataset.max_points=32",
    "model.image_feature_model=identity", "model.raster_point_radius=0.3",
    "model.point_cloud_model_embed_dim=8",
    "dataloader.batch_size=2", "dataloader.num_workers=0",
    "run.num_inference_steps=8", "logging.wandb=false",
    "run.num_sample_batches=1", "aux_run.roll_step=1",
    f"aux_run.milestones={json.dumps(MILESTONES)}",
]
CPU = ["run.cpu=true"]
BLEND = ["run.job=sample_bdm_blending", "run.mixed_precision=no",
         "run.name=blend"]
MODULES = (cli, mmain, mb, mm)


@pytest.fixture(scope="module")
def jax_weights():
    """One set of JAX params for the tiny PC2 and PVD of BASE_ARGS, with
    visible heads (PC2's 1e-6 head would hide the backbone)."""
    cfg = jax_parse_cli(BASE_ARGS + CPU + BLEND)
    jpc2 = JaxPC2(jax_cli.projection_config(cfg), sa_blocks=TINY_SA,
                  fp_blocks=TINY_FP)
    jpvd = JaxPVD(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    pc2_params = {"feature_model": {}, "point_cloud_model": _init(
        jpc2.backbone, 0, jpc2.in_channels)}
    pvd_params = _init(jpvd.backbone, 1, 3)
    rng = np.random.default_rng(2)
    _visible_head(pc2_params["point_cloud_model"], rng)
    _visible_head(pvd_params, rng)
    return jpc2, pc2_params, jpvd, pvd_params


def tiny_pc2(cfg, ckpt=None, from_ema=False):
    if from_ema and not ckpt:
        raise ValueError("run.sample_from_ema needs checkpoint.resume")
    pc2 = PC2Model(cli.projection_config(cfg), TINY_SA, TINY_FP,
                   device=cli.run_device(cfg))
    pc2.reset_parameters(cfg.run.seed)
    if ckpt:
        cli.load_weights(pc2, ckpt, from_ema=from_ema)
    return pc2


def tiny_pvd(cfg, ckpt=None):
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   mixed_precision=cfg.run.mixed_precision,
                   device=cli.run_device(cfg))
    pvd.reset_parameters(cfg.run.seed + 1)
    if ckpt:
        cli.load_weights(pvd, ckpt)
    return pvd


def tiny_fusion(cfg, pc2, pvd, ckpt=None):
    merge = BDMMergingModel(cli.projection_config(cfg), TINY_SA, TINY_FP,
                            device=cli.run_device(cfg))
    merge.init_from_pretrained(pc2, pvd, seed=cfg.run.seed + 2)
    if ckpt:
        cli.load_weights(merge, ckpt)
    return merge


def patch(monkeypatch, **fns):
    for mod in MODULES:
        for name, fn in fns.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)


@pytest.fixture
def tiny_builders(monkeypatch):
    patch(monkeypatch, build_pc2=tiny_pc2, build_pvd=tiny_pvd,
          build_fusion=tiny_fusion)


def plys(save, name, kind, which="pred"):
    return sorted(glob.glob(os.path.join(save, name, kind, which, "*",
                                         "*.ply")))


# ------------------------------------------------ (a) held to the JAX CLI

def test_blending_cli_matches_jax_cli(tmp_path, monkeypatch, jax_weights):
    jpc2, pc2_params, jpvd, pvd_params = jax_weights
    for mod in (jax_cli, jax_mb):
        monkeypatch.setattr(mod, "build_pc2", lambda cfg, ckpt=None,
                            from_ema=False: (jpc2, pc2_params))
        monkeypatch.setattr(mod, "build_pvd",
                            lambda cfg, ckpt=None: (jpvd, pvd_params))
    jax_save = str(tmp_path / "jax")
    jax_mb.main(BASE_ARGS + CPU + BLEND + [f"run.save_dir={jax_save}"])

    def port_pc2(cfg, ckpt=None, from_ema=False):
        pc2 = tiny_pc2(cfg)
        CJ.load_into(pc2, CJ.pc2_state_dict(pc2_params, pc2.backbone.specs))
        return pc2

    def port_pvd(cfg, ckpt=None):
        pvd = tiny_pvd(cfg)
        CJ.load_into(pvd, CJ.pvd_state_dict(pvd_params, pvd.model.specs))
        return pvd

    # the JAX CLI's keys: PRNGKey(run.seed) split once a batch, the
    # second half to the sampler
    sub = jax.random.split(jax.random.PRNGKey(42))[1]
    patch(monkeypatch, build_pc2=port_pc2, build_pvd=port_pvd,
          make_noise=lambda cfg, device: JaxKeyNoise(sub,
                                                     len(MILESTONES) - 1))
    save = str(tmp_path / "port")
    mb.main(BASE_ARGS + CPU + BLEND + [f"run.save_dir={save}"])

    kind = "sample_bdm_blending"
    got, want = plys(save, "blend", kind), plys(jax_save, "blend", kind)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        "synthetic_00000.ply", "synthetic_00001.ply"]
    for a, b in zip(got, want):
        pa, pb = read_ply(a), read_ply(b)
        assert pa.shape == (32, 3) and np.isfinite(pa).all()
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-3)
    for a, b in zip(plys(save, "blend", kind, "gt"),
                    plys(jax_save, "blend", kind, "gt")):
        assert open(a, "rb").read() == open(b, "rb").read()


# ------------------------------------- (b) the port's CLIs end to end

TRAIN = ["run.print_step_freq=1", "run.log_step_freq=1",
         "scheduler.num_warmup_steps=1"]


def test_merging_cli_train_then_sample(tmp_path, tiny_builders):
    save = str(tmp_path / "out")
    common = BASE_ARGS + CPU + [f"run.save_dir={save}", "run.name=merge"]
    mm.main(common + TRAIN + [
        "run.job=training_bdm_merging", "scheduler=fusion",
        "run.max_fusion_steps=2", "run.checkpoint_freq=2"])
    ckpt = os.path.join(save, "merge", "checkpoint-latest.pt")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 2
    assert os.path.exists(ckpt + ".config.json")
    mm.main(common + ["run.job=sample_bdm_merging",
                      f"aux_run.fusion_ckpt={ckpt}"])
    out = plys(save, "merge", "sample_bdm_merging")
    assert len(out) == 2
    assert all(np.isfinite(read_ply(p)).all() for p in out)


def test_main_train_bf16_then_sample_and_evaluate(tmp_path, tiny_builders,
                                                  capsys):
    save = str(tmp_path / "out")
    common = BASE_ARGS + CPU + [f"run.save_dir={save}", "run.name=pc2"]
    mmain.main(common + TRAIN + [
        "run.job=train", "run.mixed_precision=bf16", "run.max_steps=3",
        "run.checkpoint_freq=3", "ema.use_ema=true", "ema.update_every=1",
        "run.val_freq=2", "run.limit_val_batches=1", "run.vis_freq=0"])
    rows = [json.loads(line) for line in
            open(os.path.join(save, "pc2", "train_log.jsonl"))]
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    assert any("val_loss" in r for r in rows)
    ckpt = os.path.join(save, "pc2", "checkpoint-latest.pt")
    assert set(torch.load(ckpt, weights_only=True)) == {
        "model", "optimizer", "step", "best_val", "ema"}

    clouds = {}
    for ema in (False, True):
        name = f"sample_ema{int(ema)}"
        mmain.main(BASE_ARGS + CPU + [
            f"run.save_dir={save}", f"run.name={name}", "run.job=sample",
            f"checkpoint.resume={ckpt}", f"run.sample_from_ema={ema}"])
        out = plys(save, name, "sample")
        assert len(out) == 2
        clouds[ema] = [read_ply(p) for p in out]
        assert all(np.isfinite(c).all() for c in clouds[ema])

    pred = os.path.dirname(plys(save, "sample_ema1", "sample")[0])
    capsys.readouterr()
    eval_cli.main(["--pred_dir", pred, "--gt_dir",
                   pred.replace(f"{os.sep}pred{os.sep}",
                                f"{os.sep}gt{os.sep}"),
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Chamfer-L2 x1000: ")
    assert lines[0].endswith(" over 2 pairs")
    assert lines[1].startswith("F1@0.01: ")


# ------------------------------------------- (c) the `.pt` loading rules

@pytest.fixture
def tiny_cfg():
    return parse_cli(BASE_ARGS + CPU)


def test_checkpoint_ema_selection_and_errors(tmp_path, tiny_cfg):
    pc2 = tiny_pc2(tiny_cfg)
    state = {k: v.clone() for k, v in pc2.state_dict().items()}
    ema = {k: p.detach() + 1.0 for k, p in pc2.named_parameters()}
    train_ckpt = str(tmp_path / "train.pt")
    torch.save({"model": state, "optimizer": {}, "step": 3,
                "best_val": None, "ema": ema}, train_ckpt)
    no_ema = str(tmp_path / "no_ema.pt")
    torch.save({"model": state, "optimizer": {}, "step": 3,
                "best_val": None}, no_ema)
    bare = str(tmp_path / "bare.pt")
    torch.save(state, bare)

    loaded = tiny_pc2(tiny_cfg, train_ckpt, from_ema=True)
    for k, p in loaded.named_parameters():
        assert torch.equal(p, ema[k])
    for path in (train_ckpt, no_ema, bare):
        other = PC2Model(cli.projection_config(tiny_cfg), TINY_SA, TINY_FP,
                         device="cpu")
        cli.load_weights(other, path)
        for k, v in other.state_dict().items():
            assert torch.equal(v, state[k])

    with pytest.raises(ValueError, match="holds no ema"):
        tiny_pc2(tiny_cfg, no_ema, from_ema=True)
    with pytest.raises(ValueError, match="bare state_dict"):
        tiny_pc2(tiny_cfg, bare, from_ema=True)
    with pytest.raises(ValueError, match="needs checkpoint.resume"):
        cli.build_pc2(tiny_cfg, None, from_ema=True)


def test_checkpoint_missing_keys_kept_unexpected_raise(tmp_path, tiny_cfg):
    pc2 = tiny_pc2(tiny_cfg)
    init = {k: v.clone() for k, v in pc2.state_dict().items()}
    first = next(iter(init))
    partial = {first: torch.full_like(init[first], 0.5)}
    path = str(tmp_path / "partial.pt")
    torch.save(partial, path)
    cli.load_weights(pc2, path)
    for k, v in pc2.state_dict().items():
        assert torch.equal(v, partial[k] if k == first else init[k])

    extra = dict(init, **{"point_cloud_model.model.not_a_layer.weight":
                          torch.zeros(1)})
    torch.save(extra, path)
    with pytest.raises(KeyError, match="not_a_layer"):
        cli.load_weights(pc2, path)
    torch.save({"model": extra, "step": 0}, path)
    with pytest.raises(KeyError, match="not_a_layer"):
        cli.load_weights(pc2, path)


# ------------------------------- (d) no card and no run.cpu=true: raise

@pytest.mark.parametrize("main,job", [
    (mb.main, "sample_bdm_blending"), (mm.main, "training_bdm_merging"),
    (mm.main, "sample_bdm_merging"), (mmain.main, "train"),
    (mmain.main, "sample")])
def test_cli_without_a_card_raises_before_work(tmp_path, monkeypatch, main,
                                               job):
    def no_work(*args, **kwargs):
        raise AssertionError("work started without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    patch(monkeypatch, build_pc2=no_work, build_pvd=no_work,
          build_fusion=no_work, get_dataset=no_work, set_seed=no_work)
    save = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(BASE_ARGS + [f"run.job={job}", f"run.save_dir={save}"])
    assert not save.exists()


def test_eval_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(eval_cli, "evaluate_dirs", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("work started")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--pred_dir", str(tmp_path), "--gt_dir",
                       str(tmp_path)])


# ------------------------- (b) resume, evolutions, vis and lazy imports

def test_main_train_resume_and_limit_batches(tmp_path, tiny_builders,
                                             monkeypatch):
    save = str(tmp_path / "out")
    common = BASE_ARGS + CPU + TRAIN + [
        f"run.save_dir={save}", "run.name=pc2", "run.job=train",
        "run.mixed_precision=no", "run.limit_train_batches=1",
        "optimizer.scale_learning_rate_with_batch_size=true",
        "run.val_freq=0", "run.vis_freq=0", "run.checkpoint_freq=100"]
    seen = []
    real_loop = mmain.train_loop

    def loop(state, loss_fn, batches, **kw):
        def note(bs):
            for b in bs:
                seen.append(b["points"].clone())
                yield b
        return real_loop(state, loss_fn, note(batches), **kw)

    monkeypatch.setattr(mmain, "train_loop", loop)
    mmain.main(common + ["run.max_steps=2"])
    # one batch, cycled (the loop draws one past its last step); lr = batch
    # size * base lr
    assert len(seen) == 3 and all(torch.equal(b, seen[0]) for b in seen)
    ckpt = os.path.join(save, "pc2", "checkpoint-latest.pt")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 2
    lr = payload["optimizer"]["optimizer"]["param_groups"][0]["initial_lr"]
    assert lr == pytest.approx(2 * 1e-3)

    mmain.main(common + ["run.max_steps=3", f"checkpoint.resume={ckpt}"])
    # the step, the optimizer and its schedule resume: one more step
    assert torch.load(ckpt, weights_only=True)["step"] == 3
    assert len(seen) == 5
    with pytest.raises(ValueError, match="resume_training_scheduler"):
        mmain.main(common + ["run.max_steps=4", f"checkpoint.resume={ckpt}",
                             "checkpoint.resume_training_scheduler=false"])


def test_main_sample_evolutions_and_vis(tmp_path, tiny_builders):
    save = str(tmp_path / "out")
    common = BASE_ARGS + CPU + [f"run.save_dir={save}", "run.name=vis"]
    mmain.main(common + ["run.job=sample", "run.sample_save_evolutions=true",
                         "run.num_inference_steps=200"])
    pred = os.path.dirname(plys(save, "vis", "sample")[0])
    evolutions = sorted(glob.glob(os.path.join(pred, "*_evolution.png")))
    assert [os.path.basename(p) for p in evolutions] == [
        "synthetic_00000_evolution.png", "synthetic_00001_evolution.png"]
    mmain.main(common + ["run.job=vis", "run.num_inference_steps=4"])
    assert len(glob.glob(os.path.join(pred, "synthetic_*[0-9].png"))) == 2


def test_vis_helpers_and_disabled_wandb(tmp_path, monkeypatch):
    import sys

    from bdm_tpu_torch.utils import vis
    monkeypatch.setitem(sys.modules, "wandb", None)   # importing it raises
    logger = vis.WandbLogger(False, "p", "n", config={"a": 1})
    logger.log({"loss": 1.0}, step=1)
    logger.log_point_clouds({"x": np.zeros((4, 3))}, step=1)
    logger.finish()
    assert logger.run is None
    pts = np.random.default_rng(0).standard_normal((64, 3))
    vis.render_point_cloud(pts, str(tmp_path / "a" / "cloud.png"))
    vis.render_evolution([pts * s for s in np.linspace(1, 0.1, 12)],
                         str(tmp_path / "evo.png"))
    vis.dump_metadata(str(tmp_path / "m" / "meta.json"), step=3,
                      where=tmp_path)
    assert (tmp_path / "a" / "cloud.png").stat().st_size > 0
    assert (tmp_path / "evo.png").stat().st_size > 0
    assert json.loads((tmp_path / "m" / "meta.json").read_text()) == {
        "step": 3, "where": str(tmp_path)}
