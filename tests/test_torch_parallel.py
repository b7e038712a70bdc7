"""`bdm_tpu_torch.parallel` data parallelism on the CPU: the world-for-batch
rule against `bdm_tpu.parallel.get_mesh_for_batch`, the batch and noise
sharding, and the data-parallel train step and loop on two gloo ranks
spawned once for the file (`tests/torch_ranks.py::dp_rank`, one thread
each, B = 2 with one row a rank) against the JAX step on `get_mesh(2)` and
against the port's own single process.

Tolerances: against JAX, the loss within 1e-3 relative and the gradient
norm within 1e-2 (tests/test_torch_train.py's three-step test, dropout 0,
the JAX key tree's draws replayed; seeded numpy parameters of the shapes
`jax.eval_shape` gives, as tests/test_torch_sampling_surface.py makes
them); against the port's single process, the loss and gradient norm
within 1e-5 relative and every parameter within 1e-5 of its tensor's
largest entry, over a floor of 1e-7 of the model's largest (a conv bias
ahead of a GroupNorm has no gradient in exact arithmetic: both sides hold
rounding noise there), with dropout 0.1 (the keep-masks drawn at the
global batch) and SGD: Adam divides each gradient by its own
running size, so for a gradient that is zero in exact arithmetic (a conv
bias ahead of a GroupNorm) it turns the rounding noise of a sum taken in
another order into a step of the learning rate's size, while SGD keeps a
parameter's difference proportional to its gradient's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import bdm_tpu.parallel.mesh as jmesh
from bdm_tpu.parallel import get_mesh, get_mesh_for_batch
from bdm_tpu.parallel import shard_batch as jax_shard_batch
from bdm_tpu.samplers import PC2Model as JaxPC2
from bdm_tpu.samplers import ProjectionConfig as JaxCfg
from bdm_tpu.train import create_train_state as jax_create_train_state
from bdm_tpu.train import make_optimizer as jax_make_optimizer
from bdm_tpu.train import make_train_step as jax_make_train_step
from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.parallel import (ShardedNoise, backend_rule,
                                    get_world_for_batch, init_distributed,
                                    shard_batch)
from bdm_tpu_torch.samplers import NoiseProvider, PC2Model, ProjectionConfig
from bdm_tpu_torch.samplers import TrainNoise
from bdm_tpu_torch.train import (make_train_step, restore_checkpoint,
                                 train_loop)
from bdm_tpu_torch.utils import convert_jax as CJ
from tests import torch_ranks as R
from tests.test_torch_samplers import _camera
from tests.test_torch_sampling_surface import _np_params

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

B, N, S = 2, 32, 16
CFG = dict(image_size=S, image_feature_model="identity",
           raster_point_radius=0.3, point_cloud_model_embed_dim=8)
KEYS = [jax.random.PRNGKey(40 + i) for i in range(3)]


def _replay(key, shape=(B, N, 3)):
    """The (t, noise) a JAX loss draws from `key`."""
    k_t, k_noise, _ = jax.random.split(key, 3)
    return (np.array(jax.random.randint(k_t, (shape[0],), 0, 1000)),
            np.array(jax.random.normal(k_noise, shape, jnp.float32)))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """-> (the JAX mesh step's (loss, grad_norm) for three keys, the
    inputs, each rank's results, the directory)."""
    rng = np.random.default_rng(11)
    jpc2 = JaxPC2(JaxCfg(**CFG), sa_blocks=R.TINY_SA, fp_blocks=R.TINY_FP)
    jpc2.backbone = jpc2.backbone.clone(dropout=0.0)
    params = {"feature_model": {}, "point_cloud_model": _np_params(
        jpc2.backbone, ((1, N, jpc2.in_channels), jnp.float32),
        ((1,), jnp.int32))}
    image = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    points = (np.random.default_rng(21).standard_normal((B, N, 3)) * 0.3
              ).astype(np.float32)
    cam = {k: np.array(v) for k, v in _camera(B).items()}

    mesh = get_mesh(2)
    tx = jax_make_optimizer(lr=1e-3)
    # replicated from the start: the step's shardings do not change
    # between its calls, so it compiles once
    jstate = jax.device_put(jax_create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx),
        NamedSharding(mesh, P()))
    jstep = jax_make_train_step(jpc2.loss, tx, mesh=mesh)
    from bdm_tpu.conditioning import PerspectiveCamera as JaxCamera
    jbatch = jax_shard_batch({
        "image": jnp.asarray(image), "points": jnp.asarray(points),
        "camera": JaxCamera(**{k: jnp.asarray(v) for k, v in cam.items()})},
        mesh)
    want = []
    for k in KEYS:
        jstate, m = jstep(jstate, jbatch, k)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    pc2 = PC2Model(ProjectionConfig(**CFG), R.TINY_SA, R.TINY_FP,
                   device="cpu")
    CJ.load_into(pc2, CJ.pc2_state_dict(params, pc2.backbone.specs))
    inputs = {"cfg": CFG, "state": pc2.state_dict(),
              "batch": {"image": torch.from_numpy(image),
                        "points": torch.from_numpy(points),
                        "camera": {k: torch.from_numpy(v)
                                   for k, v in cam.items()}},
              "draws": [_replay(k) for k in KEYS]}
    d = tmp_path_factory.mktemp("dp")
    return want, inputs, R.run(R.dp_rank, 2, d, inputs), d


def _single_sgd(inputs, steps, accumulation=1):
    """The port's single process on the whole batch: -> (metrics and
    parameters after each step, the state)."""
    pc2 = R.tiny_pc2(inputs["cfg"], inputs["state"], 0.1)
    state = R.sgd_state(pc2, accumulation)
    step = make_train_step(pc2.loss)
    noise = TrainNoise(7, "cpu")
    batch = R.batch_of(inputs)
    out = []
    for _ in range(steps):
        m = step(state, batch, noise)
        out.append(({k: float(v) for k, v in m.items()}, R.params(pc2)))
    return out, state


def _assert_params_close(got, want):
    assert set(got) == set(want)
    floor = 1e-7 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()) + floor, (k, err)


def _assert_metrics_close(got, want, rtol=1e-5):
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= rtol * abs(want[k]), (k, got, want)


# ------------------------------------------------------------ no ranks

def test_world_for_batch_matches_jax_mesh_rule(monkeypatch):
    """Case by case against `get_mesh_for_batch` with the first `world`
    of the 8 virtual CPU devices."""
    devices = jax.devices()
    for world in range(1, 9):
        monkeypatch.setattr(jmesh.jax, "devices",
                            lambda *a, w=world: devices[:w])
        for b in range(1, 17):
            mesh = get_mesh_for_batch(b)
            assert get_world_for_batch(b, world) == (
                None if mesh is None else mesh.size), (b, world)


def test_shard_batch_takes_contiguous_rows_with_cameras():
    batch = {"points": torch.arange(24.0).reshape(4, 2, 3),
             "camera": PerspectiveCamera(
                 R=torch.arange(36.0).reshape(4, 3, 3),
                 T=torch.arange(12.0).reshape(4, 3),
                 focal_length=torch.ones(4, 2),
                 principal_point=torch.zeros(4, 2)),
             "sequence_name": ["a", "b", "c", "d"]}
    got = shard_batch(batch, 1, 2)
    assert torch.equal(got["points"], batch["points"][2:])
    assert torch.equal(got["camera"].R, batch["camera"].R[2:])
    assert torch.equal(got["camera"].T, batch["camera"].T[2:])
    assert got["sequence_name"] == ["c", "d"]
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)


def test_sharded_noise_is_rows_of_the_global_draw():
    """Each rank's timesteps, noise, keep-masks and sampler draws are its
    rows of one process's draws on the whole batch."""
    whole = TrainNoise(3, "cpu")
    t, eps = whole.draw((4, 5, 3), 1000)
    keep = whole.keep_mask((4, 2, 2), 0.1)
    p = NoiseProvider(5, "cpu")
    init, stp, mask = (p.initial((4, 5, 3)), p.step("seg", 0, 1, 2, (4, 5, 3)),
                       p.mask(0, (4, 5)))
    for r in range(2):
        tn = ShardedNoise(TrainNoise(3, "cpu"), r, 2)
        rt, reps = tn.draw((2, 5, 3), 1000)
        rows = slice(2 * r, 2 * r + 2)
        assert torch.equal(rt, t[rows]) and torch.equal(reps, eps[rows])
        assert torch.equal(tn.keep_mask((2, 2, 2), 0.1), keep[rows])
        pn = ShardedNoise(NoiseProvider(5, "cpu"), r, 2)
        assert torch.equal(pn.initial((2, 5, 3)), init[rows])
        assert torch.equal(pn.step("seg", 0, 1, 2, (2, 5, 3)), stp[rows])
        assert torch.equal(pn.mask(0, (2, 5)), mask[rows])


def test_backend_rule(monkeypatch):
    assert backend_rule(torch.device("cpu"), 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_rule(torch.device("cuda", 0), 2)[0] == "nccl"
    assert backend_rule(torch.device("cuda", 0), 3)[0] == "gloo"


def test_without_world_size_one_process(monkeypatch):
    """No `WORLD_SIZE`: the device asked for, and no process group."""
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()


# ------------------------------------------------------- on two ranks

def test_dp_steps_match_jax_mesh_step(dp):
    want, _, outs, _ = dp
    for out in outs:
        for i, ((loss, norm), m) in enumerate(zip(want, out["jax_steps"])):
            assert abs(m["loss"] - loss) <= 1e-3 * loss, (i, want)
            assert abs(m["grad_norm"] - norm) <= 1e-2 * norm, (i, want)
    assert want[2][0] < want[0][0]          # and it learns


def test_dp_steps_match_the_single_process(dp):
    """Loss, gradient norm and every parameter after each of three steps,
    dropout 0.1, and the EMA after them."""
    _, inputs, outs, _ = dp
    want, state = _single_sgd(inputs, 3)
    for out in outs:
        for (gm, gp), (wm, wp) in zip(out["sgd_steps"], want):
            _assert_metrics_close(gm, wm)
            _assert_params_close(gp, wp)
        _assert_params_close(out["sgd_ema"], state.ema)


def test_dp_accumulation_matches_the_single_process(dp):
    """Two micro-steps a window: the parameters after two windows, the loss
    and gradient norm of each closing micro-step."""
    _, inputs, outs, _ = dp
    want, _ = _single_sgd(inputs, 4, accumulation=2)
    for out in outs:
        for i in (1, 3):
            _assert_metrics_close(out["accum_steps"][i], want[i][0])
        _assert_params_close(out["accum_params"], want[3][1])


def test_dp_accumulation_all_reduces_once_a_window(dp):
    """No all-reduce on the micro-step that opens a window (`no_sync`);
    at its close, one: the gradients, their running mean and the loss."""
    _, inputs, outs, _ = dp
    n = len(list(R.tiny_pc2(inputs["cfg"], inputs["state"], 0.1)
                 .parameters()))
    for out in outs:
        assert out["accum_reduce_sizes"] == [2 * n + 1, 2 * n + 1]


def test_dp_nan_stops_every_rank_at_the_same_step(dp):
    """A NaN on rank 1 alone at micro-step 3, read at step 5: both ranks
    stop, naming step 3 (rank 0's own record would say step 5)."""
    _, _, outs, _ = dp
    assert [o["nan"] for o in outs] == [
        ("Loss is not finite at step 3.", 5)] * 2


def test_checkpoint_of_two_ranks_loads_in_one_process(dp):
    """Rank 0 alone writes; the keys are the model's own (no `module.`),
    and the checkpoint restores into one process's model: the parameters
    of the data-parallel loop, those of two single-process steps."""
    _, inputs, outs, d = dp
    path = os.path.join(d, "ckpt0", "checkpoint-latest.pt")
    assert os.path.exists(path) and not os.path.exists(
        os.path.join(d, "ckpt1"))
    payload = torch.load(path, weights_only=True)
    assert not any(k.startswith("module.") for k in payload["model"])
    pc2 = R.tiny_pc2(inputs["cfg"], inputs["state"], 0.1)
    state = restore_checkpoint(path, R.sgd_state(pc2))
    assert state.step == 2
    for k, p in pc2.named_parameters():
        assert torch.equal(p, outs[0]["loop_params"][k]), k
    one = R.tiny_pc2(inputs["cfg"], inputs["state"], 0.1)
    train_loop(R.sgd_state(one), one.loss,
               iter(lambda: R.batch_of(inputs), None), 2,
               TrainNoise(7, "cpu"), print_freq=10 ** 9)
    _assert_params_close(outs[0]["loop_params"], R.params(one))


def test_sharded_pc2_refuses_its_loops():
    """A point-sharded PC2 serves `denoise`; its loss and sampling loops
    would draw at the shard's shape, so they refuse (the group is not
    reached before that)."""
    pc2 = PC2Model(ProjectionConfig(**CFG), R.TINY_SA, R.TINY_FP,
                   device="cpu", sp_group=object())
    batch = {"image": torch.zeros(1, S, S, 3), "camera": None,
             "points": torch.zeros(1, N, 3)}
    for call in (lambda: pc2.sample(batch, N),
                 lambda: pc2.interaction_sample(batch["points"], batch, 8,
                                                0, 8, None),
                 lambda: pc2.loss(batch, TrainNoise(0, "cpu"))):
        with pytest.raises(NotImplementedError, match="serves denoise"):
            call()
