"""`bdm_tpu_torch` BDM-Merging (fusion network, DDIM, the merging sampler)
against `bdm_tpu`, on the CPU at float32 with tiny specs.

One set of JAX parameters per module: a tiny PC2 and PVD, and the fusion
tree `init_from_pretrained` makes of them with its zero-convs RANDOMISED
(at zero the fusion network equals PC2 and the injection would go
untested). Tolerances: the fusion forward within 1e-4 of max|out| (float32
sums taken in another order through ~25 layers); a DDIM step within 1e-6;
the samplers, which replay the JAX key tree through a noise provider,
within 1e-3 absolute, as the BDM-Blending test; weight round trips
bit-exact (transposes only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bdm_tpu_torch
from bdm_tpu.diffusion.ddim import DDIMScheduler as JaxDDIM
from bdm_tpu.diffusion.schedules import linear_betas
from bdm_tpu.samplers import BDMMergingModel as JaxMerge
from bdm_tpu.samplers import PC2Model as JaxPC2
from bdm_tpu.samplers import ProjectionConfig as JaxCfg
from bdm_tpu.samplers import PVDModel as JaxPVD
from bdm_tpu.samplers import bdm_blending as jax_blending
from bdm_tpu.samplers import bdm_merging as jax_merging
from bdm_tpu.utils import convert_torch as CT
from bdm_tpu_torch.diffusion import DDIMScheduler
from bdm_tpu_torch.models import PVCNNFuse
from bdm_tpu_torch.samplers import (BDMMergingModel, NoiseProvider, PC2Model,
                                    ProjectionConfig, PVDModel, bdm_blending,
                                    bdm_merging)
from bdm_tpu_torch.samplers.blending import prior_schedule
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA
from tests.test_torch_models import _assert_trees_equal
from tests.test_torch_samplers import (B, N, S, JaxKeyNoise, _cams, _init,
                                       _visible_head)

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

CFG = dict(image_size=S, image_feature_model="identity",
           raster_point_radius=0.3, point_cloud_model_embed_dim=8)
TINY = dict(sa_blocks=TINY_SA, fp_blocks=TINY_FP)


class World:
    """The JAX models and parameters and the port's models loaded with
    the same weights."""

    def __init__(self):
        jcfg = JaxCfg(**CFG)
        self.jpc2 = JaxPC2(jcfg, **TINY)
        self.jpvd = JaxPVD(embed_dim=8, **TINY)
        self.jmerge = JaxMerge(jcfg, pc2=self.jpc2, **TINY)
        rng = np.random.default_rng(11)
        self.pc2_params = {"feature_model": {}, "point_cloud_model": _init(
            self.jpc2.backbone, 0, self.jpc2.in_channels)}
        self.pvd_params = _init(self.jpvd.backbone, 1, 3)
        _visible_head(self.pc2_params["point_cloud_model"], rng)
        _visible_head(self.pvd_params, rng)
        # `init_from_pretrained` with the fusion init jitted (the eager
        # init takes half a minute on the CPU): fresh projections, towers
        # of the pretrained encoders, decoder and embedf copies of PC2's
        fuse = jax.jit(functools.partial(self.jmerge.fusion.init,
                                         mode="fusion_nstep"))(
            jax.random.PRNGKey(2),
            jnp.zeros((1, N, self.jpc2.in_channels)), jnp.zeros((1, N, 3)),
            jnp.zeros((1,), jnp.int32))
        pc2_tree = self.pc2_params["point_cloud_model"]["params"]
        fm = dict(fuse["params"], pc2_encoder=pc2_tree["encoder"],
                  pvd_encoder=self.pvd_params["params"]["encoder"],
                  decoder=pc2_tree["decoder"], embedf=pc2_tree["embedf"])
        self.merge_params = jax.tree_util.tree_map(
            np.array, {"feature_model": {}, "fusion_model": {"params": fm}})
        fm = self.merge_params["fusion_model"]["params"]
        for i in range(len(TINY_SA)):
            zc = fm[f"proj{i}"]["zero_conv"]
            assert not zc["kernel"].any()      # zero as initialised
            zc["kernel"] = (rng.standard_normal(zc["kernel"].shape) * 0.3
                            ).astype(np.float32)
            zc["bias"] = (rng.standard_normal(zc["bias"].shape) * 0.1
                          ).astype(np.float32)

        cfg = ProjectionConfig(**CFG)
        self.pc2 = PC2Model(cfg, TINY_SA, TINY_FP, device="cpu")
        self.pvd = PVDModel(embed_dim=8, device="cpu", **TINY)
        self.merge = BDMMergingModel(cfg, TINY_SA, TINY_FP, device="cpu")
        CJ.load_into(self.pc2, CJ.pc2_state_dict(self.pc2_params,
                                                 self.pc2.backbone.specs))
        CJ.load_into(self.pvd, CJ.pvd_state_dict(self.pvd_params,
                                                 self.pvd.model.specs))
        fusion = self.merge.fusion
        CJ.load_into(self.merge, CJ.fusion_state_dict(
            fm, fusion.pc2_specs, fusion.pvd_specs))
        self.image = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
        self.jcam, self.tcam = _cams(B)

    def jax_batch(self):
        return {"image": jnp.asarray(self.image), "camera": self.jcam}

    def torch_batch(self):
        return {"image": torch.from_numpy(self.image), "camera": self.tcam}


@pytest.fixture(scope="module")
def world():
    return World()


def _fusion_inputs(in_channels):
    rng = np.random.default_rng(12)
    x_cond = rng.standard_normal((B, N, in_channels)).astype(np.float32)
    x_cond[..., :3] *= 0.5
    x_prior = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    return x_cond, x_prior, np.array([517, 3], np.int32)


# ------------------------------------------------------------- the network

@pytest.mark.parametrize("mode", ["fusion_nstep", "fusion_1step"])
def test_pvcnn_fuse_matches_jax(world, mode):
    x_cond, x_prior, t = _fusion_inputs(world.jpc2.in_channels)
    apply = jax.jit(functools.partial(world.jmerge.fusion.apply, mode=mode))
    want = np.asarray(apply(world.merge_params["fusion_model"],
                            jnp.asarray(x_cond), jnp.asarray(x_prior),
                            jnp.asarray(t)))
    with torch.no_grad():
        got = world.merge.fusion(torch.from_numpy(x_cond),
                                 torch.from_numpy(x_prior),
                                 torch.from_numpy(t).long(), mode).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (B, N, 3)
    assert np.abs(got - want).max() < 1e-4 * scale, (
        np.abs(got - want).max(), scale)
    # the injection is live: the prior cloud moves the output in nstep mode
    with torch.no_grad():
        moved = world.merge.fusion(torch.from_numpy(x_cond),
                                   torch.from_numpy(x_prior[:, ::-1].copy()),
                                   torch.from_numpy(t).long(), mode).numpy()
    assert (np.abs(moved - got).max() > 1e-3 * scale) == (
        mode == "fusion_nstep")


@pytest.mark.parametrize("mode", ["fusion_nstep", "fusion_1step"])
def test_zero_conv_fusion_equals_pc2(world, mode):
    """`init_from_pretrained` copies towers, decoder and embedf and leaves
    the zero-convs at zero: the fusion output is the PC2 backbone's."""
    merge = BDMMergingModel(ProjectionConfig(**CFG), TINY_SA, TINY_FP,
                            device="cpu")
    merge.reset_parameters(5)
    merge.init_from_pretrained(world.pc2, world.pvd, seed=3)
    proj = merge.fusion.projs[0]
    assert not proj[3].weight.any() and proj[0].weight.any()
    x_cond, x_prior, t = _fusion_inputs(world.pc2.in_channels)
    args = (torch.from_numpy(x_cond), torch.from_numpy(x_prior),
            torch.from_numpy(t).long())
    with torch.no_grad():
        got = merge.fusion(*args, mode)
        want = world.pc2.backbone(args[0], args[2])
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fusion_state_dict_round_trip_tiny(world):
    """JAX fusion tree -> port state_dict -> `convert_torch`'s fusion
    converters (at the tiny specs) -> the same tree, bit for bit."""
    sd = {k: v.numpy() for k, v in world.merge.state_dict().items()}
    fusion = world.merge.fusion
    assert len(sd) == len(fusion.state_dict())      # identity features
    pre = "fusion_model.model"
    pc2_specs = CT.build_pvcnn2_specs(
        TINY_SA, TINY_FP, extra_feature_channels=world.pc2.in_channels - 3)
    pvd_specs = CT.build_pvcnn2_specs(TINY_SA, TINY_FP,
                                      extra_feature_channels=0)
    back = {
        "embedf": CT._timestep_mlp(sd, f"{pre}.embedf"),
        "decoder": CT.convert_decoder(sd, pre, pc2_specs,
                                      fp_key="fusion_decoder_fp_layers"),
        "pc2_encoder": CT._convert_tower(
            sd, f"{pre}.pc2_model_sa_layers", f"{pre}.pc2_model_global_att",
            pc2_specs),
        "pvd_encoder": CT._convert_tower(
            sd, f"{pre}.pvd_model_sa_layers", f"{pre}.pvd_model_global_att",
            pvd_specs),
        **{f"proj{i}": {
            "conv1": CT._dense(sd, f"{pre}.projs.{i}.0"),
            "conv2": CT._dense(sd, f"{pre}.projs.{i}.2"),
            "zero_conv": CT._dense(sd, f"{pre}.projs.{i}.3"),
        } for i in range(len(fusion.projs))},
    }
    _assert_trees_equal(back, world.merge_params["fusion_model"]["params"])


def test_fusion_state_dict_round_trip_full_width():
    """At the published widths: port state_dict ->
    `convert_fusion_checkpoint` -> `fusion_state_dict` -> the same
    state_dict, bit for bit, key for key."""
    fuse = PVCNNFuse(extra_feature_channels=387)
    fuse.reset_parameters(0)
    with torch.no_grad():
        for proj in fuse.projs:           # a visible zero-conv
            proj[3].weight.normal_(generator=torch.Generator().manual_seed(1))
    sd = {f"fusion_model.model.{k}": v.numpy()
          for k, v in fuse.state_dict().items()}
    tree = CT.convert_fusion_checkpoint(sd, in_channels=390)
    back = CJ.fusion_state_dict(tree, fuse.pc2_specs, fuse.pvd_specs)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].reshape(v.shape), v, err_msg=k)


# --------------------------------------------------------------- schedulers

@pytest.mark.parametrize("steps", [1000, 64])
def test_ddim_step(steps):
    betas = linear_betas(1e-5, 8e-3)
    jd, td = JaxDDIM(betas), DDIMScheduler(betas)
    ts = jd.set_timesteps(steps)
    np.testing.assert_array_equal(td.set_timesteps(steps), ts)
    rng = np.random.default_rng(steps)
    x, eps = (rng.standard_normal((2, 64, 3)).astype(np.float32)
              for _ in range(2))
    for t in (int(ts[0]), int(ts[len(ts) // 2]), 0):
        for eta in (0.0, 0.5):
            key = jax.random.PRNGKey(t)
            z = np.array(jax.random.normal(key, x.shape, jnp.float32))
            want = np.asarray(jd.step(jnp.asarray(eps), t, jnp.asarray(x),
                                      key=key, eta=eta))
            got = td.step(torch.from_numpy(eps), t, torch.from_numpy(x),
                          torch.from_numpy(z), eta=eta).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        td.step(torch.from_numpy(eps), 5, torch.from_numpy(x), None, eta=0.5)


def test_ddim_milestone_mapping():
    """`main_blending.py:214-222`: the prior runs 16 * roll steps over
    milestones rescaled by 1000 / 64; DDPM keeps both."""
    ms = [64, 62, 60, 56, 8, 4, 2, 0]
    assert prior_schedule(ms, 2, "ddpm") == (ms, 2)
    assert prior_schedule(ms, 2, "ddim") == (
        [1000, 968, 937, 875, 125, 62, 31, 0], 32)
    with pytest.raises(ValueError):
        prior_schedule(ms, 2, "pndm")


# ----------------------------------------------------------------- samplers

@pytest.mark.parametrize("scheduler", ["ddpm", "ddim"])
def test_bdm_merging_tiny_matches_jax(world, scheduler):
    """8 steps, three interior milestones: each runs a one-step roll of
    both branches (31 prior steps under the DDIM mapping) and a fusion
    step with live zero-convs."""
    milestones, roll, steps = [8, 6, 4, 2, 0], 2, 8
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_merging(
        world.jmerge, world.merge_params, world.jpc2, world.pc2_params,
        world.jpvd, world.pvd_params, world.jax_batch(), key, num_points=N,
        milestones=milestones, roll_step=roll, scheduler=scheduler,
        num_inference_steps=steps))
    got = bdm_merging(world.merge, world.pc2, world.pvd, world.torch_batch(),
                      num_points=N, milestones=milestones, roll_step=roll,
                      noise=JaxKeyNoise(key, len(milestones) - 1),
                      num_inference_steps=steps, scheduler=scheduler).numpy()
    assert got.shape == (B, N, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_bdm_merging_precontract_matches_jax(world):
    """BDM-Merging with `precontract` on PC2: its windows and rolls take
    the precontracted conditioning, the fusion step the raw map (as
    `bdm_tpu/samplers/merging.py:207`); DDPM, 8 steps, JAX keys replayed:
    within 1e-3."""
    jpc2 = JaxPC2(JaxCfg(**CFG, precontract=True), **TINY)
    pc2 = PC2Model(ProjectionConfig(**CFG, precontract=True), TINY_SA,
                   TINY_FP, device="cpu")
    pc2.load_state_dict(world.pc2.state_dict())
    assert pc2.precontract_enabled
    milestones, roll, steps = [8, 6, 4, 2, 0], 2, 8
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax_merging(
        world.jmerge, world.merge_params, jpc2, world.pc2_params,
        world.jpvd, world.pvd_params, world.jax_batch(), key, num_points=N,
        milestones=milestones, roll_step=roll, num_inference_steps=steps))
    got = bdm_merging(world.merge, pc2, world.pvd, world.torch_batch(),
                      num_points=N, milestones=milestones, roll_step=roll,
                      noise=JaxKeyNoise(key, len(milestones) - 1),
                      num_inference_steps=steps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_bdm_blending_ddim_matches_jax(world):
    """The DDIM milestone mapping inside BDM-Blending: recon in the
    8-step DDIM space, the prior 16 steps from int(m / 64 * 1000)."""
    milestones, roll, steps = [8, 6, 3, 0], 1, 8
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_blending(
        world.jpc2, world.pc2_params, world.jpvd, world.pvd_params,
        world.jax_batch(), key, num_points=N, milestones=milestones,
        roll_step=roll, scheduler="ddim", num_inference_steps=steps))
    got = bdm_blending(world.pc2, world.pvd, world.torch_batch(),
                       num_points=N, milestones=milestones, roll_step=roll,
                       noise=JaxKeyNoise(key, len(milestones) - 1),
                       num_inference_steps=steps, scheduler="ddim").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


class JaxLoopNoise(NoiseProvider):
    """Replays `bdm_tpu`'s `BDMMergingModel.sample`: split(key) ->
    (k_init, k_loop); step j draws from split(k_loop, n_steps)[j]."""

    def __init__(self, key):
        self.k_init, self.k_loop = jax.random.split(key)

    def initial(self, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.k_init, shape, jnp.float32)))

    def step(self, branch, i, j, n_steps, shape):
        k = jax.random.split(self.k_loop, n_steps)[j]
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))


def test_merging_model_sample_matches_jax(world):
    key = jax.random.PRNGKey(5)
    want = np.asarray(world.jmerge.sample(
        world.merge_params, world.jax_batch(), key, num_points=N,
        num_inference_steps=4))
    got = world.merge.sample(world.torch_batch(), N, noise=JaxLoopNoise(key),
                             num_inference_steps=4).numpy()
    assert got.shape == (B, N, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------------ device default

@pytest.mark.parametrize("make", [
    lambda **kw: PC2Model(ProjectionConfig(**CFG), TINY_SA, TINY_FP, **kw),
    lambda **kw: PVDModel(embed_dim=8, **TINY, **kw),
    lambda **kw: BDMMergingModel(ProjectionConfig(**CFG), TINY_SA, TINY_FP,
                                 **kw),
    lambda **kw: NoiseProvider(seed=0, **kw),
], ids=["PC2Model", "PVDModel", "BDMMergingModel", "NoiseProvider"])
def test_entry_points_default_to_the_card(make, monkeypatch):
    """Without `device` an entry point asks for the card and raises when
    there is none; it never carries on on the CPU. `device="cpu"` is the
    caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bdm_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    obj = make(device="cpu")
    dev = (next(obj.parameters()).device if isinstance(obj, torch.nn.Module)
           else obj.device)
    assert dev.type == "cpu"
