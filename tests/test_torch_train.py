"""`bdm_tpu_torch` training (the three losses, their gradients, `train/`)
against `bdm_tpu`, on the CPU at float32 with tiny specs.

One set of JAX parameters per module (the `World` of
tests/test_torch_merging.py: a tiny PC2 and PVD with visible heads and the
fusion tree made of them with live zero-convs). Most tests run both sides
with dropout 0: the JAX backbones are cloned with `dropout=0.0` (nothing in
`bdm_tpu` changes) and the port's `Dropout`s are set to p = 0. Timesteps
and noise replay the JAX key tree (`k_t, k_noise, k_drop = split(key, 3)`)
through `TrainNoise`. At p = 0.1 flax's keep-masks are replayed too: they
are captured inside the traced loss with `flax.linen.intercept_methods`
around each `nn.Dropout` call (keep-mask = output != 0, over inputs that
are all non-zero) and handed to the port through `TrainNoise(replay=...)`
as the third item of a step. The port's own masks come from a generator
that `TrainNoise` seeds: one seed gives one step bit for bit, another seed
another step.

Tolerances: a loss within 1e-5 relative; every parameter's gradient within
1e-4 of that tensor's largest entry (float32 sums taken in another order
through ~25 layers forward and back; 1e-5 holds for most tensors but not
for the first layers, where the whole depth accumulates); the optimizer
alone on made-up gradients within 1e-6; three whole steps within 1e-3
relative on the loss, with a visible head: under PC2's 1e-6 head every
backbone gradient is ~1e-6 and Adam's m / sqrt(v) turns rounding noise
into learning-rate sized differences, so that head is held to gradient
parity only.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from bdm_tpu.train import create_train_state as jax_create_train_state
from bdm_tpu.train import make_lr_schedule as jax_make_lr_schedule
from bdm_tpu.train import make_optimizer as jax_make_optimizer
from bdm_tpu.train import make_train_step as jax_make_train_step
from bdm_tpu.utils import convert_torch as CT
from bdm_tpu_torch.models.layers import GroupNormCL
from bdm_tpu_torch.samplers import NoiseProvider, TrainNoise, bdm_blending
from bdm_tpu_torch.tools.standins import training_batches
from bdm_tpu_torch.train import (MetricLogger, NaNLossError,
                                 create_train_state, fusion_freeze_mask,
                                 load_params, make_lr_schedule,
                                 make_optimizer, make_train_step,
                                 pc2_freeze_mask, restore_checkpoint,
                                 save_checkpoint, save_params, train_loop)
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA
from tests.test_torch_merging import World
from tests.test_torch_models import _assert_trees_equal
from tests.test_torch_samplers import B, N

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

T = 1000


@pytest.fixture(scope="module")
def world():
    w = World()
    w.jpc2_dropout_backbone = w.jpc2.backbone      # p = 0.1, as built
    w.jpc2.backbone = w.jpc2.backbone.clone(dropout=0.0)
    w.jpvd.backbone = w.jpvd.backbone.clone(dropout=0.0)
    w.jmerge.fusion = w.jmerge.fusion.clone(dropout=0.0)
    for model in (w.pc2, w.pvd, w.merge):
        for m in model.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
    w.points = (np.random.default_rng(21).standard_normal((B, N, 3)) * 0.3
                ).astype(np.float32)
    # PC2's loss and gradients, compiled once for the tests that take them
    w.jpc2_value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, k: w.jpc2.loss(p, b, k)))
    return w


def _replay(key, shape=(B, N, 3)):
    """The (t, noise) a JAX loss draws from `key`."""
    k_t, k_noise, _ = jax.random.split(key, 3)
    return (np.array(jax.random.randint(k_t, (shape[0],), 0, T)),
            np.array(jax.random.normal(k_noise, shape, jnp.float32)))


def _noise(*keys):
    return TrainNoise(device="cpu", replay=[_replay(k) for k in keys])


def _batches(w):
    return (dict(w.jax_batch(), points=jnp.asarray(w.points)),
            dict(w.torch_batch(), points=torch.from_numpy(w.points)))


def _cases(w):
    """name -> (port model, JAX (loss, gradients) of (params, key), JAX
    params, port loss of a noise, gradient tree -> port names)."""
    jb, tb = _batches(w)
    f = w.merge.fusion

    def jvg(loss):
        return jax.jit(jax.value_and_grad(loss))

    return {
        "pc2": (w.pc2, lambda p, k: w.jpc2_value_and_grad(p, jb, k),
                w.pc2_params,
                lambda n: w.pc2.loss(tb, n),
                lambda g: CJ.grads_state_dict(g, w.pc2.backbone.specs)),
        "pvd": (w.pvd, jvg(lambda p, k: w.jpvd.loss(p, jb["points"], k)),
                w.pvd_params, lambda n: w.pvd.loss(tb["points"], n),
                lambda g: CJ.grads_state_dict(g, w.pvd.model.specs, "model")),
        "merging": (w.merge, jvg(lambda p, k: w.jmerge.loss(p, jb, k)),
                    w.merge_params, lambda n: w.merge.loss(tb, n),
                    lambda g: CJ.fusion_grads_state_dict(g, f.pc2_specs,
                                                         f.pvd_specs)),
    }


# ------------------------------------------------- losses and gradients

def _assert_grads_close(got, want, floor_over=lambda k: True):
    """Every tensor within 1e-4 of its largest entry, over a floor of 1e-6
    of the largest entry among the tensors `floor_over` selects (all, by
    default): a conv bias ahead of a GroupNorm has no gradient in exact
    arithmetic, and both sides hold only rounding noise there."""
    floor = 1e-6 * max(np.abs(w).max() for k, w in want.items()
                       if floor_over(k))
    assert floor > 0
    for k, w in want.items():
        g = got[k].numpy().reshape(w.shape)
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max() + floor, (k, err,
                                                       np.abs(w).max())


@pytest.mark.parametrize("name", ["pc2", "pvd", "merging"])
def test_loss_and_gradients_match_jax(world, name):
    model, jvg, jparams, tloss, names = _cases(world)[name]
    key = jax.random.PRNGKey(31)
    want_loss, want = jvg(jparams, key)
    want = names(jax.tree_util.tree_map(np.asarray, want))
    model.zero_grad(set_to_none=True)
    model.train()          # the train path; the dropouts are at p = 0
    try:
        loss = tloss(_noise(key))
    finally:
        model.eval()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    _assert_grads_close(got, want)
    model.zero_grad(set_to_none=True)


def _port_dropout(model, p):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = p


def test_pc2_dropout_matches_jax_with_replayed_masks(world):
    """p = 0.1 on both sides: the JAX loss draws its masks from `k_drop`;
    they are captured in the traced loss and replayed through
    `TrainNoise`, one a dropout site in the order the sites run."""
    import flax.linen as fnn
    jb, tb = _batches(world)
    key = jax.random.PRNGKey(33)
    jpc2 = world.jpc2

    def loss_and_masks(params, k):
        masks, inputs_nonzero = [], []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (isinstance(context.module, fnn.Dropout)
                    and context.method_name == "__call__"):
                masks.append(out != 0)
                inputs_nonzero.append(jnp.all(args[0] != 0))
            return out

        with fnn.intercept_methods(capture):
            loss = jpc2.loss(params, jb, k)
        return loss, (masks, inputs_nonzero)

    no_dropout, jpc2.backbone = jpc2.backbone, world.jpc2_dropout_backbone
    try:
        (want_loss, (masks, nonzero)), want = jax.jit(jax.value_and_grad(
            loss_and_masks, has_aux=True))(world.pc2_params, key)
    finally:
        jpc2.backbone = no_dropout
    assert len(masks) == 1 + sum(len(stage.convs) for stage in (
        *world.pc2.backbone.specs.sa_stages,
        *world.pc2.backbone.specs.fp_stages))
    assert all(bool(v) for v in nonzero)
    masks = [np.array(m) for m in masks]
    assert all(0.8 < m.mean() < 0.97 for m in masks)   # p = 0.1 dropped
    want = CJ.grads_state_dict(jax.tree_util.tree_map(np.asarray, want),
                               world.pc2.backbone.specs)
    model = world.pc2
    noise = TrainNoise(device="cpu", replay=[(*_replay(key), masks)])
    model.zero_grad(set_to_none=True)
    _port_dropout(model, 0.1)
    model.train()
    try:
        loss = model.loss(tb, noise)
    finally:
        model.eval()
        _port_dropout(model, 0.0)
    assert next(noise.masks, None) is None          # every mask was used
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    _assert_grads_close({k: p.grad for k, p in model.named_parameters()},
                        want)
    model.zero_grad(set_to_none=True)


def test_tiny_pc2_head_gradient_parity(world):
    """PC2's own 1e-6 head: gradient parity still holds, which is all it
    is held to. Every gradient behind the head shrinks with it to ~1e-6 of
    the head's own, so the floor is taken over those tensors alone: one
    from the head's O(1) gradient would be as large as the values
    compared."""
    params = jax.tree_util.tree_map(np.array, world.pc2_params)
    head = params["point_cloud_model"]["params"]["decoder"]["classifier_out"]
    rng = np.random.default_rng(5)
    for k in ("kernel", "bias"):
        head[k] = (rng.standard_normal(head[k].shape) * 1e-6).astype(
            np.float32)
    saved = {k: v.clone() for k, v in world.pc2.state_dict().items()}
    CJ.load_into(world.pc2, CJ.pc2_state_dict(params,
                                              world.pc2.backbone.specs))
    try:
        jb, tb = _batches(world)
        key = jax.random.PRNGKey(32)
        _, want = world.jpc2_value_and_grad(params, jb, key)
        want = CJ.grads_state_dict(jax.tree_util.tree_map(np.asarray, want),
                                   world.pc2.backbone.specs)
        world.pc2.zero_grad(set_to_none=True)
        world.pc2.loss(tb, _noise(key)).backward()
        head_keys = [k for k in want if ".classifier.2." in k]
        assert len(head_keys) == 2
        behind = max(np.abs(w).max() for k, w in want.items()
                     if k not in head_keys)
        assert 0 < behind < 1e-4 * min(np.abs(want[k]).max()
                                       for k in head_keys)
        _assert_grads_close({k: p.grad for k, p
                             in world.pc2.named_parameters()}, want,
                            floor_over=lambda k: k not in head_keys)
    finally:
        world.pc2.load_state_dict(saved)
        world.pc2.zero_grad(set_to_none=True)


# ------------------------------------------------------ optimizer alone

class _Toy(nn.Module):
    """dense (kernel, bias) + norm (scale, bias): one decayed tensor and
    three that are not."""

    def __init__(self, params):
        super().__init__()
        self.dense = nn.Linear(4, 8)
        self.norm = GroupNormCL(2, 8)
        with torch.no_grad():
            self.dense.weight.copy_(torch.from_numpy(
                params["dense"]["kernel"].T.copy()))
            self.dense.bias.copy_(torch.from_numpy(params["dense"]["bias"]))
            self.norm.weight.copy_(torch.from_numpy(
                params["norm"]["scale"]))
            self.norm.bias.copy_(torch.from_numpy(params["norm"]["bias"]))

    def tree(self):
        return {"dense": {"kernel": self.dense.weight.detach().numpy().T,
                          "bias": self.dense.bias.detach().numpy()},
                "norm": {"scale": self.norm.weight.detach().numpy(),
                         "bias": self.norm.bias.detach().numpy()}}

    def set_grads(self, g):
        self.dense.weight.grad = torch.from_numpy(g["dense"]["kernel"].T
                                                  .copy())
        self.dense.bias.grad = torch.from_numpy(g["dense"]["bias"].copy())
        self.norm.weight.grad = torch.from_numpy(g["norm"]["scale"].copy())
        self.norm.bias.grad = torch.from_numpy(g["norm"]["bias"].copy())


def _toy_tree(rng, scale=1.0):
    return {"dense": {"kernel": (rng.standard_normal((4, 8)) * scale
                                 ).astype(np.float32),
                      "bias": (rng.standard_normal(8) * scale
                               ).astype(np.float32)},
            "norm": {"scale": (rng.standard_normal(8) * scale
                               ).astype(np.float32),
                     "bias": (rng.standard_normal(8) * scale
                              ).astype(np.float32)}}


@pytest.mark.parametrize("name,accum", [("AdamW", 1), ("AdamW", 2),
                                        ("Adam", 1), ("SGD", 1),
                                        ("Adadelta", 1)])
def test_optimizer_matches_optax(name, accum):
    """clip 50 + optimizer + cosine schedule with warm-up + no-decay groups
    + accumulation on a made-up sequence of gradients, two of them above
    the clip. A large weight decay makes the decay groups visible."""
    rng = np.random.default_rng(7)
    params = _toy_tree(rng)
    grads = [_toy_tree(rng, s) for s in (1.0, 30.0, 0.1, 1.0, 40.0, 1.0,
                                         0.5, 2.0)]
    kw = dict(name=name, lr=1e-2, weight_decay=0.1,
              gradient_accumulation_steps=accum)
    tx = jax_make_optimizer(schedule=jax_make_lr_schedule(
        "cosine", 1e-2, 2, 6), **kw)
    jp, jstate = params, tx.init(params)
    toy = _Toy(params)
    opt = make_optimizer(toy, schedule=make_lr_schedule("cosine", 1e-2, 2, 6),
                         **kw)
    import optax
    for i, g in enumerate(grads):
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        toy.set_grads(g)
        norm = opt.apply_gradients()
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-4 * float(
            norm)
        for (path, want), got in zip(
                jax.tree_util.tree_flatten_with_path(jp)[0],
                jax.tree_util.tree_leaves(toy.tree())):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{i} {path}")
    # the decayed kernel and the undecayed bias really differ in treatment
    if name == "AdamW":
        groups = opt.optimizer.param_groups
        assert [len(g["params"]) for g in groups] == [1, 3]
        assert [g["weight_decay"] for g in groups] == [0.1, 0.0]


@pytest.mark.parametrize("name", ["linear", "cosine", "constant"])
def test_lr_schedule_matches_jax(name):
    want = jax_make_lr_schedule(name, 1e-3, 5, 40)
    got = make_lr_schedule(name, 1e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-6,
                            abs_tol=1e-10), step
    with pytest.raises(ValueError):
        make_lr_schedule("exponential")


# ----------------------------------------------------------- whole steps

def test_three_train_steps_match_jax(world):
    jb, tb = _batches(world)
    tx = jax_make_optimizer(lr=1e-3)
    params = jax.tree_util.tree_map(jnp.array, world.pc2_params)
    jstate = jax_create_train_state(params, tx)
    jstep = jax_make_train_step(world.jpc2.loss, tx)
    keys = [jax.random.PRNGKey(40 + i) for i in range(3)]
    want = []
    for k in keys:
        jstate, m = jstep(jstate, jb, k)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    saved = {k: v.clone() for k, v in world.pc2.state_dict().items()}
    try:
        state = create_train_state(world.pc2, make_optimizer(world.pc2))
        step = make_train_step(world.pc2.loss)
        noise = _noise(*keys)
        for i, (loss, norm) in enumerate(want):
            m = step(state, tb, noise)
            assert not world.pc2.training
            assert abs(float(m["loss"]) - loss) <= 1e-3 * loss, (i, want)
            assert abs(float(m["grad_norm"]) - norm) <= 1e-2 * norm, (i, want)
        assert state.step == 3
        assert want[2][0] < want[0][0]          # and it learns
    finally:
        world.pc2.load_state_dict(saved)
        world.pc2.zero_grad(set_to_none=True)


# ------------------------------------- the port's own tiny models below

def _tiny_pc2(seed=0, dropout=0.1, **cfg):
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    pc2 = PC2Model(ProjectionConfig(
        image_size=16, image_feature_model="identity",
        raster_point_radius=0.3, point_cloud_model_embed_dim=8, **cfg),
        TINY_SA, TINY_FP, device="cpu", dropout=dropout)
    pc2.reset_parameters(seed)
    with torch.no_grad():      # a visible head
        head = pc2.backbone.classifier[2].weight
        head.copy_(torch.randn(head.shape,
                               generator=torch.Generator().manual_seed(5))
                   * 0.1)
    return pc2


def _batch_iter(seed=1, repeat=True):
    return training_batches(seed, 2, 32, "cpu", image_size=16, repeat=repeat)


def test_freeze_masks():
    from bdm_tpu_torch.samplers import (BDMMergingModel, PC2Model,
                                        ProjectionConfig)
    from bdm_tpu_torch.tools.standins import live_zero_convs
    vit = dict(patch_size=4, embed_dim=16, depth=1, num_heads=2)
    cfg = ProjectionConfig(image_size=16, image_feature_model="tiny",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, vit_kwargs=vit, device="cpu")
    pc2.reset_parameters(0)
    pc2_freeze_mask(pc2)
    merge = BDMMergingModel(cfg, TINY_SA, TINY_FP, vit_kwargs=vit,
                            device="cpu")
    merge.reset_parameters(1)
    live_zero_convs(merge, 2)
    fusion_freeze_mask(merge)
    frozen_names = ("feature_model.", "pc2_model_sa_layers",
                    "pc2_model_global_att", "pvd_model_sa_layers",
                    "pvd_model_global_att")
    for model, frozen in ((pc2, frozen_names[:1]), (merge, frozen_names)):
        names = {k: any(f in k for f in frozen)
                 for k, _ in model.named_parameters()}
        assert any(names.values()) and not all(names.values())
        assert all(p.requires_grad != names[k]
                   for k, p in model.named_parameters())
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = create_train_state(model, make_optimizer(model, lr=1e-2))
        step = make_train_step(model.loss)
        step(state, next(_batch_iter()), TrainNoise(0, "cpu"))
        for k, p in model.named_parameters():
            if names[k]:
                assert torch.equal(p, before[k]), k       # did not move
                assert p.grad is None
        moved = [k for k, p in model.named_parameters()
                 if not names[k] and not torch.equal(p, before[k])]
        assert any("fp_layers" in k for k in moved)
        if model is merge:
            assert any("projs" in k for k in moved)
            assert any("embedf" in k for k in moved)
    # unfrozen on request
    pc2b = PC2Model(cfg, TINY_SA, TINY_FP, vit_kwargs=vit, device="cpu")
    pc2_freeze_mask(pc2b, freeze_feature_model=False)
    assert all(p.requires_grad for p in pc2b.parameters())


def test_ema_updates_only_on_schedule():
    pc2 = _tiny_pc2()
    state = create_train_state(pc2, make_optimizer(pc2, lr=1e-2),
                               use_ema=True, ema_decay=0.5,
                               ema_update_every=2)
    step = make_train_step(pc2.loss)
    batch, noise = next(_batch_iter()), TrainNoise(0, "cpu")
    name = "point_cloud_model.model.classifier.2.weight"
    e0 = state.ema[name].clone()
    assert torch.equal(e0, dict(pc2.named_parameters())[name])
    step(state, batch, noise)                       # step 1: no update
    assert torch.equal(state.ema[name], e0)
    step(state, batch, noise)                       # step 2: update
    p = dict(pc2.named_parameters())[name].detach()
    torch.testing.assert_close(state.ema[name], 0.5 * e0 + 0.5 * p)
    assert not torch.equal(state.ema[name], e0)


def test_checkpoint_roundtrip(tmp_path, world):
    pc2 = _tiny_pc2(dropout=0.0)   # no masks: two runs can be compared
    sched = make_lr_schedule("linear", 1e-3, 2, 10)
    opt = make_optimizer(pc2, schedule=sched)
    state = create_train_state(pc2, opt, use_ema=True, ema_update_every=1)
    step = make_train_step(pc2.loss)
    batch = next(_batch_iter())
    for _ in range(2):
        step(state, batch, TrainNoise(0, "cpu"))
    path = save_checkpoint(str(tmp_path), state, config={"lr": 1e-3})
    assert (tmp_path / "checkpoint-latest.pt.config.json").exists()

    other = _tiny_pc2(seed=9, dropout=0.0)
    fresh = create_train_state(
        other, make_optimizer(other, schedule=sched), use_ema=True)
    restore_checkpoint(path, fresh)
    assert fresh.step == 2
    for (k, a), (_, b_) in zip(pc2.state_dict().items(),
                               other.state_dict().items()):
        assert torch.equal(a, b_), k
    for k in state.ema:
        assert torch.equal(state.ema[k], fresh.ema[k])
    assert fresh.optimizer.learning_rate() == state.optimizer.learning_rate()
    # both continue alike: the Adam moments came along
    m1 = step(state, batch, TrainNoise(3, "cpu"))
    m2 = make_train_step(other.loss)(fresh, batch, TrainNoise(3, "cpu"))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b_ in zip(pc2.parameters(), other.parameters()):
        assert torch.equal(a, b_)
    # partial resume: weights only
    third = _tiny_pc2(seed=10)
    st3 = create_train_state(third, make_optimizer(third))
    restore_checkpoint(path, st3, restore_optimizer=False,
                       restore_step=False)
    assert st3.step == 0 and not st3.optimizer.optimizer.state

    # a saved model carries the reference keys: `bdm_tpu`'s converter reads
    # it back into the JAX parameters the port was loaded with
    ppath = save_params(str(tmp_path / "pc2.pt"), world.pc2)
    sd = {k: v.numpy() for k, v in torch.load(ppath,
                                              weights_only=True).items()}
    specs = CT.build_pvcnn2_specs(
        TINY_SA, TINY_FP, extra_feature_channels=world.pc2.in_channels - 3)
    pre = "point_cloud_model.model"
    back = {"params": {"embedf": CT._timestep_mlp(sd, f"{pre}.embedf"),
                       "encoder": CT.convert_encoder(sd, pre, specs),
                       "decoder": CT.convert_decoder(sd, pre, specs)}}
    _assert_trees_equal(back, world.pc2_params["point_cloud_model"])
    again = _tiny_pc2(seed=11)
    load_params(ppath, again)
    for a, b_ in zip(world.pc2.parameters(), again.parameters()):
        assert torch.equal(a, b_)


def test_nan_guard_names_the_step():
    """A NaN injected at step 3 is reported as step 3 although the loop
    only looks every 5 steps."""
    pc2 = _tiny_pc2()
    state = create_train_state(pc2, make_optimizer(pc2))
    calls = {"n": 0}

    def loss_fn(batch, noise):
        calls["n"] += 1
        loss = pc2.loss(batch, noise)
        return loss * float("nan") if calls["n"] == 3 else loss

    with pytest.raises(NaNLossError, match="step 3"):
        train_loop(state, loss_fn, _batch_iter(), 10, TrainNoise(0, "cpu"),
                   log_step_freq=5, print_freq=10 ** 9)
    assert state.step == 5               # read at the log cadence


def test_train_loop_runs_logs_and_checkpoints(tmp_path):
    pc2 = _tiny_pc2(dropout=0.0)
    # one repeated batch and one repeated draw: the loss must fall
    draw = (np.array([3, 700]), np.random.default_rng(0).standard_normal(
        (2, 32, 3)).astype(np.float32))
    opt = make_optimizer(pc2, schedule=make_lr_schedule("constant", 1e-3, 0,
                                                        10))
    state = create_train_state(pc2, opt, use_ema=True)
    logger = MetricLogger(jsonl_path=str(tmp_path / "log.jsonl"))
    seen = []
    train_loop(state, pc2.loss, _batch_iter(), 4,
               TrainNoise(device="cpu", replay=itertools.repeat(draw)),
               checkpoint_dir=str(tmp_path), checkpoint_freq=2,
               log_step_freq=2, print_freq=10 ** 9, logger=logger,
               callbacks=[lambda s, st, m: seen.append(float(m["loss"]))])
    assert state.step == 4 and len(seen) == 4 and not pc2.training
    assert seen[-1] < seen[0]            # a repeated batch is learnt
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"lr": 0.001' in lines[0]
    assert (tmp_path / "checkpoint-latest.pt").exists()
    # the iterator may end before max_steps
    train_loop(state, pc2.loss, itertools.islice(_batch_iter(), 1), 10,
               TrainNoise(0, "cpu"), print_freq=10 ** 9)
    assert state.step == 5


def test_gradient_accumulation_cadence():
    """k = 2: parameters move at every second micro-step only, and two
    micro-steps on one batch and noise equal one plain step (the mean of
    two equal gradients)."""
    a, b_ = _tiny_pc2(dropout=0.0), _tiny_pc2(dropout=0.0)
    sa = create_train_state(a, make_optimizer(
        a, lr=1e-2, gradient_accumulation_steps=2))
    sb = create_train_state(b_, make_optimizer(b_, lr=1e-2))
    batch = next(_batch_iter())
    draw = [(np.array([3, 700]), np.random.default_rng(0).standard_normal(
        (2, 32, 3)).astype(np.float32))]
    before = [p.detach().clone() for p in a.parameters()]
    step = make_train_step(a.loss)
    step(sa, batch, TrainNoise(device="cpu", replay=draw))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), before))
    step(sa, batch, TrainNoise(device="cpu", replay=draw))
    assert any(not torch.equal(p, q) for p, q in zip(a.parameters(), before))
    make_train_step(b_.loss)(sb, batch, TrainNoise(device="cpu", replay=draw))
    for p, q in zip(a.parameters(), b_.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    assert sa.step == 2 and sb.step == 1


def test_sampling_is_unchanged_by_a_training_step():
    """A step leaves the model in `eval()`: with the same weights (lr 0)
    sampling after it equals sampling before it, and builds no graph."""
    from bdm_tpu_torch.samplers import PVDModel
    pc2 = _tiny_pc2()
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    pvd.reset_parameters(1)
    assert not pc2.training and not pvd.training
    batch = next(_batch_iter())
    view = {"image": batch["image"], "camera": batch["camera"]}

    def sample():
        return bdm_blending(pc2, pvd, view, 32, [4, 3, 1, 0], 1,
                            noise=NoiseProvider(seed=7, device="cpu"),
                            num_inference_steps=4)

    before = sample()
    assert not before.requires_grad
    state = create_train_state(pc2, make_optimizer(pc2, lr=0.0))
    m = make_train_step(pc2.loss)(state, batch, TrainNoise(0, "cpu"))
    assert float(m["grad_norm"]) > 0 and not pc2.training
    assert torch.equal(sample(), before)
    # in train() mode the same call would differ: dropout is live there
    pc2.train()
    assert not torch.equal(sample(), before)
    pc2.eval()


def test_train_noise():
    a, b_ = TrainNoise(3, "cpu"), TrainNoise(3, "cpu")
    t1, n1 = a.draw((4, 8, 3), T)
    t2, n2 = b_.draw((4, 8, 3), T)
    assert torch.equal(t1, t2) and torch.equal(n1, n2)
    assert t1.dtype == torch.long and t1.shape == (4,)
    assert 0 <= int(t1.min()) and int(t1.max()) < T
    assert n1.shape == (4, 8, 3) and n1.dtype == torch.float32
    t3, _ = a.draw((4, 8, 3), T)
    assert not torch.equal(t1, t3)
    with pytest.raises(ValueError):
        TrainNoise(device="cpu", replay=[(np.zeros(3), np.zeros((4, 8, 3)))]
                   ).draw((4, 8, 3), T)


def test_train_noise_dropout_masks():
    """Keep-masks from a generator of their own, seeded from the seed:
    reproducible, independent of the timesteps' stream, Bernoulli(1 - p);
    a replayed mask of the wrong shape or one too few raises."""
    a, b_, c = (TrainNoise(s, "cpu") for s in (3, 3, 4))
    m1, m2, m3 = (n.keep_mask((64, 128), 0.1) for n in (a, b_, c))
    assert m1.dtype == torch.bool and m1.shape == (64, 128)
    assert torch.equal(m1, m2) and not torch.equal(m1, m3)
    assert 0.85 < m1.float().mean().item() < 0.95
    t1, _ = a.draw((4, 8, 3), T)
    t2, _ = TrainNoise(3, "cpu").draw((4, 8, 3), T)
    assert torch.equal(t1, t2)          # masks drew nothing from it
    draw = (np.zeros(2), np.zeros((2, 8, 3)), [np.ones((2, 5), bool)])
    n = TrainNoise(device="cpu", replay=[draw, draw])
    n.draw((2, 8, 3), T)
    assert n.keep_mask((2, 5), 0.1).all()
    with pytest.raises(ValueError):
        n.keep_mask((2, 5), 0.1)
    n.draw((2, 8, 3), T)
    with pytest.raises(ValueError):
        n.keep_mask((2, 6), 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_dropout_step_is_a_function_of_the_seed(seed):
    """One training step at p = 0.1 from one `TrainNoise` seed is bit-equal
    twice on the CPU, whatever PyTorch's global generator holds; another
    seed (same timesteps and noise) gives another loss."""
    batch = next(_batch_iter())
    draw = [(np.array([3, 700]), np.random.default_rng(0).standard_normal(
        (2, 32, 3)).astype(np.float32))]

    def one_step(noise_seed, global_seed):
        pc2 = _tiny_pc2()
        state = create_train_state(pc2, make_optimizer(pc2, lr=1e-2))
        with torch.random.fork_rng():
            torch.manual_seed(global_seed)
            m = make_train_step(pc2.loss)(
                state, batch, TrainNoise(noise_seed, "cpu", replay=draw))
        return float(m["loss"]), [p.detach() for p in pc2.parameters()]

    loss, params = one_step(seed, 0)
    again, params_again = one_step(seed, 1)
    assert loss == again
    assert all(torch.equal(p, q) for p, q in zip(params, params_again))
    other, _ = one_step(seed + 2, 0)
    assert other != loss


def test_forward_noising_matches_jax(world):
    """`add_noise` (PC2) and `q_sample` (PVD, float64 tables) at
    per-sample timesteps."""
    rng = np.random.default_rng(3)
    x0, eps = (rng.standard_normal((4, 16, 3)).astype(np.float32)
               for _ in range(2))
    t = np.array([0, 1, 500, 999])
    want = world.jpc2.schedulers["ddpm"].add_noise(
        jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
    got = world.pc2.schedulers["ddpm"].add_noise(
        torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    want = world.jpvd.diffusion.q_sample(jnp.asarray(x0), jnp.asarray(t),
                                         jnp.asarray(eps))
    got = world.pvd.diffusion.q_sample(
        torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_bf16_training_step_runs():
    """bf16 compute, float32 parameters and gradients; the blend takes its
    gather form at this size, as the dispatch rule says."""
    pc2 = _tiny_pc2(mixed_precision="bf16")
    state = create_train_state(pc2, make_optimizer(pc2))
    m = make_train_step(pc2.loss)(state, next(_batch_iter()),
                                  TrainNoise(0, "cpu"))
    assert math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(p.grad.dtype == torch.float32 and p.dtype == torch.float32
               for p in pc2.parameters() if p.grad is not None)
