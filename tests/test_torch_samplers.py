"""`bdm_tpu_torch` conditioning, schedulers and BDM-Blending against
`bdm_tpu`.

Tolerances: the surface projection is exact (the same points win the same
pixels); a DDPM step and a Gaussian p_sample with the same noise agree
within 1e-6 (float32 coefficients computed in the same order); the tiny
BDM-Blending run, which replays the JAX key tree through a noise provider,
ends within 1e-3 absolute (eight denoise steps of float32 sums taken in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu.conditioning import PerspectiveCamera as JaxCamera
from bdm_tpu.conditioning.projection import surface_projection as jax_proj
from bdm_tpu.diffusion import GaussianDiffusion as JaxGaussian
from bdm_tpu.diffusion import pvd_betas
from bdm_tpu.diffusion.ddpm import DDPMScheduler as JaxDDPM
from bdm_tpu.diffusion.schedules import linear_betas
from bdm_tpu.samplers import PC2Model as JaxPC2
from bdm_tpu.samplers import ProjectionConfig as JaxCfg
from bdm_tpu.samplers import PVDModel as JaxPVD
from bdm_tpu.samplers import bdm_blending as jax_blending
from bdm_tpu_torch.conditioning import PerspectiveCamera, surface_projection
from bdm_tpu_torch.diffusion import DDPMScheduler, GaussianDiffusion
from bdm_tpu_torch.diffusion import linear_betas as port_linear_betas
from bdm_tpu_torch.diffusion import pvd_betas as port_pvd_betas
from bdm_tpu_torch.samplers import (NoiseProvider, PC2Model,
                                    ProjectionConfig, PVDModel, bdm_blending)
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

B, N, S = 2, 32, 16


def _camera(b):
    return dict(R=np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)),
                T=np.broadcast_to(np.array([0.0, 0.0, 2.0], np.float32),
                                  (b, 3)),
                focal_length=np.full((b, 2), 2.0, np.float32),
                principal_point=np.zeros((b, 2), np.float32))


def _cams(b):
    c = _camera(b)
    return (JaxCamera(**{k: jnp.asarray(v) for k, v in c.items()}),
            PerspectiveCamera(**{k: torch.tensor(np.array(v))
                                 for k, v in c.items()}))


@pytest.mark.parametrize("size,radius", [(16, 0.3), (64, 0.02)],
                         ids=["K5", "K2"])
def test_surface_projection_exact(size, radius):
    rng = np.random.default_rng(size)
    pts = (rng.standard_normal((2, 512, 3)) * 0.4).astype(np.float32)
    fmap = rng.uniform(1, 2, (2, size, size, 4)).astype(np.float32)
    jcam, tcam = _cams(2)
    want = np.asarray(jax_proj(jnp.asarray(pts), jcam, jnp.asarray(fmap),
                               radius=radius))
    got = surface_projection(torch.from_numpy(pts), tcam,
                             torch.from_numpy(fmap), radius=radius).numpy()
    won = (want != 0).any(-1)
    assert 0 < won.sum() < won.size        # some points win, some lose
    np.testing.assert_array_equal((got != 0).any(-1), won)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [1000, 50])
def test_ddpm_step(steps):
    betas = port_linear_betas(1e-5, 8e-3)
    np.testing.assert_array_equal(betas, linear_betas(1e-5, 8e-3))
    jd = JaxDDPM(linear_betas(1e-5, 8e-3))
    td = DDPMScheduler(betas)
    ts = jd.set_timesteps(steps)
    np.testing.assert_array_equal(td.set_timesteps(steps), ts)
    rng = np.random.default_rng(steps)
    x, eps = (rng.standard_normal((2, 64, 3)).astype(np.float32)
              for _ in range(2))
    for t in (int(ts[0]), int(ts[len(ts) // 2]), 0):
        key = jax.random.PRNGKey(t)
        z = np.array(jax.random.normal(key, x.shape, jnp.float32))
        want = np.asarray(jd.step(jnp.asarray(eps), t, jnp.asarray(x), key))
        got = td.step(torch.from_numpy(eps), t, torch.from_numpy(x),
                      torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gaussian_p_sample():
    betas = port_pvd_betas("linear", 1e-4, 2e-2, 1000)
    np.testing.assert_array_equal(betas,
                                  pvd_betas("linear", 1e-4, 2e-2, 1000))
    jg = JaxGaussian(pvd_betas("linear", 1e-4, 2e-2, 1000))
    tg = GaussianDiffusion(betas)
    rng = np.random.default_rng(0)
    x, eps = (rng.standard_normal((2, 64, 3)).astype(np.float32)
              for _ in range(2))
    for t in (999, 500, 1, 0):
        key = jax.random.PRNGKey(t)
        z = np.array(jax.random.normal(key, x.shape, jnp.float32))
        want = np.asarray(jg.p_sample(
            lambda xx, tt: jnp.asarray(eps), jnp.asarray(x),
            jnp.full((2,), t, jnp.int32), key))
        got = tg.p_sample(lambda xx, tt: torch.from_numpy(eps),
                          torch.from_numpy(x), t, torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class JaxKeyNoise(NoiseProvider):
    """Replays the key tree of `bdm_tpu.samplers.bdm_blending` and
    `bdm_merging`: split(key) -> (k_init, key); per milestone
    split(key, 5) -> (k_seg, k_recon, k_prior, k_mix or k_f, key); per
    window split(k, n_steps). The fourth key draws the blend mask in
    BDM-Blending and the fusion step's noise in BDM-Merging."""

    def __init__(self, key, times):
        k_init, key = jax.random.split(key)
        self.k_init, self.keys = k_init, []
        for _ in range(times):
            k_seg, k_r, k_p, k_mix, key = jax.random.split(key, 5)
            self.keys.append(dict(seg=k_seg, recon=k_r, prior=k_p,
                                  mix=k_mix))

    def initial(self, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.k_init, shape, jnp.float32)))

    def step(self, branch, i, j, n_steps, shape):
        k = jax.random.split(self.keys[i][branch], n_steps)[j]
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))

    def mask(self, i, shape):
        return torch.from_numpy(np.array(
            jax.random.randint(self.keys[i]["mix"], shape, 0, 2)))

    def fuse(self, i, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.keys[i]["mix"], shape, jnp.float32)))


def _init(backbone, seed, channels):
    params = jax.jit(backbone.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, N, channels), jnp.float32),
        jnp.zeros((1,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


def _visible_head(params, rng):
    head = params["params"]["decoder"]["classifier_out"]
    head["kernel"] = (rng.standard_normal(head["kernel"].shape) * 0.1
                      ).astype(np.float32)


def test_bdm_blending_tiny_matches_jax():
    """PC2 + PVD, DDPM with 8 steps, two interior milestones (both branch
    rolls and the blend run twice), identity image features."""
    jcfg = JaxCfg(image_size=S, image_feature_model="identity",
                  raster_point_radius=0.3, point_cloud_model_embed_dim=8)
    jpc2 = JaxPC2(jcfg, sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    jpvd = JaxPVD(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    pc2_params = {"feature_model": {}, "point_cloud_model": _init(
        jpc2.backbone, 0, jpc2.in_channels)}
    pvd_params = _init(jpvd.backbone, 1, 3)
    rng = np.random.default_rng(2)
    _visible_head(pc2_params["point_cloud_model"], rng)
    _visible_head(pvd_params, rng)

    image = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    jcam, tcam = _cams(B)
    milestones, roll, steps = [8, 7, 5, 3, 0], 1, 8
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_blending(
        jpc2, pc2_params, jpvd, pvd_params,
        {"image": jnp.asarray(image), "camera": jcam}, key, num_points=N,
        milestones=milestones, roll_step=roll, num_inference_steps=steps))

    cfg = ProjectionConfig(image_size=S, image_feature_model="identity",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, device="cpu")
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    CJ.load_into(pc2, CJ.pc2_state_dict(pc2_params, pc2.backbone.specs))
    CJ.load_into(pvd, CJ.pvd_state_dict(pvd_params, pvd.model.specs))
    got = bdm_blending(pc2, pvd, {"image": torch.from_numpy(image),
                                  "camera": tcam},
                       num_points=N, milestones=milestones, roll_step=roll,
                       noise=JaxKeyNoise(key, len(milestones) - 1),
                       num_inference_steps=steps).numpy()
    assert got.shape == (B, N, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_default_noise_is_seeded():
    cfg = ProjectionConfig(image_size=S, image_feature_model="identity",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, device="cpu")
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    pc2.reset_parameters(0)
    pvd.reset_parameters(1)
    _, tcam = _cams(B)
    batch = {"image": torch.rand(B, S, S, 3,
                                 generator=torch.Generator().manual_seed(0)),
             "camera": tcam}
    outs = [bdm_blending(pc2, pvd, batch, N, [4, 3, 1, 0], 1,
                         noise=NoiseProvider(seed=7, device="cpu"),
                         num_inference_steps=4) for _ in range(2)]
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
