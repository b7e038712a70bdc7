"""`bdm_tpu_torch.models.coloring` against `bdm_tpu.models.coloring`, on the
CPU at float32, on the tiny configuration of `tests/test_extras.py`
(identity features at image 16, embedding 8, one block, `TINY_SA` /
`TINY_FP`).

One set of JAX parameters for the module (the output projection made
visible: at its N(0, 1e-6^2) init every colour is 0.5). The loss replays
the JAX key tree (`k_noise, k_drop = split(key)`) through `TrainNoise`:
the position noise as the noise of a step, and in one case flax's dropout
keep-masks, captured with `flax.linen.intercept_methods` as
`tests/test_torch_train.py` does. With dropout 0 the JAX blocks' PVCNN2 is
built with `dropout=0.0` (the test patches the name the JAX module looks
up; nothing in `bdm_tpu` changes).

Tolerances: `predict` within 1e-4 absolute (colours in [0, 1]; float32
sums in another order through ~30 layers); a loss within 1e-5 relative;
every parameter's gradient within 1e-4 of that tensor's largest entry over
a floor of 1e-6 of the largest gradient (the rule of
`tests/test_torch_train.py`); weight round trips bit-exact (transposes
only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import bdm_tpu.models.coloring as jax_coloring
from bdm_tpu.conditioning import PerspectiveCamera as JaxCamera
from bdm_tpu.samplers import ProjectionConfig as JaxCfg
from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.models import (PointCloudColoringModel,
                                  PointCloudModelBlock,
                                  PointCloudTransformerModel)
from bdm_tpu_torch.samplers import ProjectionConfig, TrainNoise
from bdm_tpu_torch.tools.standins import training_batches
from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                 train_loop)
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

B, N, S = 2, 32, 16
CFG = dict(image_size=S, image_feature_model="identity",
           raster_point_radius=0.3, predict_shape=False, predict_color=True,
           point_cloud_model_embed_dim=8)
TINY = dict(sa_blocks=TINY_SA, fp_blocks=TINY_FP)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        points=(rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32),
        colors=rng.uniform(0, 1, (B, N, 3)).astype(np.float32),
        image=rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32),
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)),
        T=np.broadcast_to(np.array([0.0, 0.0, 2.0], np.float32), (B, 3)),
        focal_length=np.full((B, 2), 2.0, np.float32),
        principal_point=np.zeros((B, 2), np.float32))


def _batches(a):
    cam = {k: a[k] for k in ("R", "T", "focal_length", "principal_point")}
    jb = {k: jnp.asarray(a[k]) for k in ("points", "colors", "image")}
    jb["camera"] = JaxCamera(**{k: jnp.asarray(v) for k, v in cam.items()})
    tb = {k: torch.from_numpy(a[k]) for k in ("points", "colors", "image")}
    tb["camera"] = PerspectiveCamera(**{k: torch.tensor(np.array(v))
                                        for k, v in cam.items()})
    return jb, tb


class World:
    def __init__(self):
        self.jmodel = jax_coloring.PointCloudColoringModel(
            JaxCfg(**CFG), point_cloud_model_layers=1, **TINY)
        pcm = jax.jit(self.jmodel.model.init)(
            jax.random.PRNGKey(0),
            jnp.zeros((1, N, self.jmodel.pc2.in_channels), jnp.float32))
        pcm = jax.tree_util.tree_map(np.array, pcm)
        head = pcm["params"]["output_projection"]
        head["kernel"] = (np.random.default_rng(5).standard_normal(
            head["kernel"].shape) * 0.3).astype(np.float32)
        self.init_tree = jax.tree_util.tree_map(np.array, pcm)
        self.params = {"feature_model": {}, "point_cloud_model": pcm}
        self.model = PointCloudColoringModel(ProjectionConfig(**CFG), 1,
                                             device="cpu", **TINY)
        self.specs = self.model.point_cloud_model.block0.pvcnn.specs
        CJ.load_into(self.model, CJ.coloring_state_dict(self.params,
                                                        self.specs))
        self.jb, self.tb = _batches(_arrays())


@pytest.fixture(scope="module")
def world():
    return World()


def _port_dropout(model, p):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = p


def _assert_grads_close(got, want):
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    assert floor > 0
    for k, w in want.items():
        g = got[k].numpy().reshape(w.shape)
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max() + floor, (k, err,
                                                       np.abs(w).max())


def test_predict_matches_jax(world):
    want = np.asarray(jax.jit(world.jmodel.predict)(world.params, world.jb))
    got = world.model.predict(world.tb)
    assert got.shape == (B, N, 3)
    assert 0.05 < want.std()             # the colours are not all 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_layernorm_eps_is_flax(world):
    """eps 1e-6 (flax), not torch's 1e-5: on inputs a thousand times
    smaller the embedding's variance is ~1e-7, where the two differ by a
    factor of ~3 in the normalised value."""
    eps = [m.eps for m in world.model.modules() if isinstance(m,
                                                                nn.LayerNorm)]
    assert eps == [1e-6, 1e-6]
    x = (np.random.default_rng(3).standard_normal(
        (B, N, world.jmodel.pc2.in_channels)) * 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(world.jmodel.model.apply)(
        world.params["point_cloud_model"], jnp.asarray(x)))
    with torch.no_grad():
        got = world.model.point_cloud_model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _replay(key, shape=(B, N, 3)):
    """The position noise a JAX colouring loss draws from `key`, as the
    (t, noise) of a `TrainNoise` step (t unused)."""
    k_noise, _ = jax.random.split(key)
    return (np.zeros(shape[0], np.int64),
            np.array(jax.random.normal(k_noise, shape, jnp.float32)))


def _port_loss_and_grads(world, noise, noise_std):
    model = world.model
    model.zero_grad(set_to_none=True)
    model.train()
    try:
        loss = model.loss(world.tb, noise, noise_std)
    finally:
        model.eval()
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_loss_and_gradients_match_jax(world, monkeypatch):
    """noise_std 0.1, dropout 0 on both sides: every parameter's
    gradient against `jax.value_and_grad`."""
    monkeypatch.setattr(jax_coloring, "PVCNN2", functools.partial(
        jax_coloring.PVCNN2, dropout=0.0))
    key = jax.random.PRNGKey(41)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, k: world.jmodel.loss(p, world.jb, k, noise_std=0.1)))(
            world.params, key)
    want = CJ.coloring_state_dict(jax.tree_util.tree_map(np.asarray, want),
                                  world.specs)
    _port_dropout(world.model, 0.0)
    try:
        loss, got = _port_loss_and_grads(
            world, TrainNoise(device="cpu", replay=[_replay(key)]), 0.1)
    finally:
        _port_dropout(world.model, 0.1)
    assert abs(loss - float(want_loss)) <= 1e-5 * float(want_loss)
    assert set(got) == set(want)
    _assert_grads_close(got, want)


def test_loss_with_replayed_dropout_masks_matches_jax(world):
    """p = 0.1 on both sides: flax's keep-masks, captured in the traced
    loss, replayed through `TrainNoise` in the order the sites run."""
    import flax.linen as fnn
    key = jax.random.PRNGKey(43)

    def loss_and_masks(params, k):
        masks, nonzero = [], []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (isinstance(context.module, fnn.Dropout)
                    and context.method_name == "__call__"):
                masks.append(out != 0)
                nonzero.append(jnp.all(args[0] != 0))
            return out

        with fnn.intercept_methods(capture):
            loss = world.jmodel.loss(params, world.jb, k, noise_std=0.1)
        return loss, (masks, nonzero)

    (want_loss, (masks, nonzero)), want = jax.jit(jax.value_and_grad(
        loss_and_masks, has_aux=True))(world.params, key)
    specs = world.specs
    assert len(masks) == 1 + sum(len(st.convs) for st in (
        *specs.sa_stages, *specs.fp_stages))
    assert all(bool(v) for v in nonzero)
    masks = [np.array(m) for m in masks]
    assert all(0.8 < m.mean() < 0.97 for m in masks)   # p = 0.1 dropped
    want = CJ.coloring_state_dict(jax.tree_util.tree_map(np.asarray, want),
                                  specs)
    noise = TrainNoise(device="cpu", replay=[(*_replay(key), masks)])
    loss, got = _port_loss_and_grads(world, noise, 0.1)
    assert next(noise.masks, None) is None          # every mask was used
    assert abs(loss - float(want_loss)) <= 1e-5 * float(want_loss)
    _assert_grads_close(got, want)


def test_use_attn_raises():
    with pytest.raises(NotImplementedError):
        PointCloudModelBlock(8, use_attn=True, **TINY)


def test_shape_prediction_is_refused():
    with pytest.raises(ValueError):
        PointCloudColoringModel(ProjectionConfig(**dict(
            CFG, predict_shape=True)), device="cpu", **TINY)


def test_backbone_stays_float32_under_bf16():
    """`mixed_precision` bf16 leaves the colouring backbone float32 (the
    JAX blocks give their PVCNN2 no dtype)."""
    model = PointCloudColoringModel(ProjectionConfig(**dict(
        CFG, mixed_precision="bf16")), device="cpu", **TINY)
    pv = model.point_cloud_model.block0.pvcnn
    assert pv.dtype is None and pv.encoder.dtype is None


def test_output_projection_init_scale(world):
    """Kernel and bias N(0, 1e-6^2), as the JAX init draws them."""
    jax_out = world.init_tree["params"]["output_projection"]
    model = PointCloudTransformerModel(1, 9, 3, 8, **TINY)
    model.reset_parameters(7)
    port = {"kernel": model.output_projection.weight.detach().numpy(),
            "bias": model.output_projection.bias.detach().numpy()}
    jax_fresh = jax.jit(world.jmodel.model.init)(
        jax.random.PRNGKey(9), jnp.zeros((1, N, 9), jnp.float32))
    jax_fresh = jax_fresh["params"]["output_projection"]
    for name in ("kernel", "bias"):
        for w in (port[name], np.asarray(jax_fresh[name])):
            assert 0 < np.abs(w).max() < 1e-5
            assert 3e-7 < w.std() < 3e-6
    assert jax_out["bias"].shape == port["bias"].shape
    assert (model.block0.norm0.weight == 1).all()


def test_state_dict_round_trip(world):
    """JAX tree -> `coloring_state_dict` -> the port -> `state_dict`:
    every key, bit-exact; a second model loaded from that state_dict
    predicts the same colours."""
    conv = CJ.coloring_state_dict(world.params, world.specs)
    sd = world.model.state_dict()
    assert set(sd) == set(conv)
    for k, v in conv.items():
        np.testing.assert_array_equal(sd[k].numpy().reshape(v.shape), v,
                                      err_msg=k)
    again = PointCloudColoringModel(ProjectionConfig(**CFG), 1,
                                    device="cpu", **TINY)
    again.load_state_dict(sd)
    assert torch.equal(again.predict(world.tb),
                       world.model.predict(world.tb))


def test_trains_through_train_loop():
    """Two steps of `train_loop` (AdamW, EMA): finite losses, parameters
    moved."""
    model = PointCloudColoringModel(ProjectionConfig(**CFG), 1,
                                    device="cpu", **TINY)
    model.reset_parameters(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(3)

    def batches():
        for b in training_batches(1, B, N, "cpu", image_size=S):
            yield dict(b, colors=torch.rand(B, N, 3, generator=g))

    losses = []
    state = create_train_state(model, make_optimizer(model), use_ema=True)
    train_loop(state, lambda b, n: model.loss(b, n, 0.01), batches(), 2,
               TrainNoise(0, device="cpu"), log_step_freq=1,
               print_freq=10 ** 9,
               callbacks=[lambda s, st, m: losses.append(float(m["loss"]))])
    assert state.step == 2 and len(losses) == 2
    assert all(np.isfinite(losses))
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith("point_cloud_model.output_projection")
               for k in moved)
    assert any(".pvcnn." in k for k in moved)
