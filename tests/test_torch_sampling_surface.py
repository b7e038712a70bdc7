"""PC2's and PVD's sampling and conditioning surface in `bdm_tpu_torch`
against `bdm_tpu`: PNDM, the beta schedules, the Gaussian diffusion's
variants, the nearest-centre projection, the distance transform, every
channel accounting of `ProjectionConfig`, the backbone mux, full PC2 and
PVD sampling, the precontracted stage-0 conv and BDM-Blending with it.

Tiny specs (`TINY_SA` / `TINY_FP`, 16 px images, identity features or a
two-block ViT), float32 on the CPU. The parameters are seeded numpy
arrays of the shapes `jax.eval_shape` gives the JAX modules (nothing is
compiled to make them), made once per set of shapes for the module, and
every JAX forward is one jitted call. Tolerances, stated per test:
exact for indices, projections, schedules and the distance transform;
1e-6 for one Gaussian step and the voxel helpers (float32, same order);
1e-5 for a PNDM trajectory compared step by step (one float32 rounding a
step, carried); 1e-4 of the largest output for one denoise (float32 sums
in another order through ~20 layers, as `test_torch_models.py`); 1e-3
absolute for whole tiny trajectories (`test_torch_samplers.py`).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu.conditioning import distance_transform as jdt
from bdm_tpu.conditioning.projection import surface_projection as jax_proj
from bdm_tpu.diffusion import GaussianDiffusion as JaxGaussian
from bdm_tpu.diffusion import PNDMScheduler as JaxPNDM
from bdm_tpu.diffusion import custom_betas as jax_custom_betas
from bdm_tpu.diffusion import make_scheduler as jax_make_scheduler
from bdm_tpu.diffusion import pvd_betas as jax_pvd_betas
from bdm_tpu.models import feature_model as jfm
from bdm_tpu.models import simple as jsimple
from bdm_tpu.models.pvcnn import PVCNN2 as JaxPVCNN2
from bdm_tpu.ops import conv_wide as jconv_wide
from bdm_tpu.ops import voxelize as jvox
from bdm_tpu.samplers import PC2Model as JaxPC2
from bdm_tpu.samplers import ProjectionConfig as JaxCfg
from bdm_tpu.samplers import PVDModel as JaxPVD
from bdm_tpu.samplers import bdm_blending as jax_blending
from bdm_tpu_torch import ops
from bdm_tpu_torch.conditioning import (compute_distance_transform,
                                        surface_projection)
from bdm_tpu_torch.diffusion import (GaussianDiffusion, PNDMScheduler,
                                     custom_betas, linear_betas,
                                     make_scheduler, pvd_betas)
from bdm_tpu_torch.samplers import (NoiseProvider, PC2Model,
                                    ProjectionConfig, PVDModel, bdm_blending)
from bdm_tpu_torch.samplers.pc2 import Conditioning, PrecontractedCond
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA
from tests.test_torch_models import TINY_VIT
from tests.test_torch_samplers import B, N, S, JaxKeyNoise, _cams

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

BASE = dict(image_size=S, image_feature_model="identity",
            raster_point_radius=0.3, point_cloud_model_embed_dim=8)


@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    """The JAX feature model finds the tiny ViT by name."""
    jfm.MODEL_KWARGS["tiny"] = TINY_VIT
    yield
    del jfm.MODEL_KWARGS["tiny"]


def _tiny_pvcnn2(**kw):
    return JaxPVCNN2(sa_blocks=TINY_SA, fp_blocks=TINY_FP, **kw)


def _leaf(path, shape, rng):
    """A seeded leaf: fan-in normal kernels, biases N(0, 0.1^2), scales
    near 1, token and position embeddings N(0, 0.02^2)."""
    name = path[-1].key
    if name == "kernel":
        w = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "bias":
        w = 0.1 * rng.standard_normal(shape)
    elif name == "scale":
        w = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        w = 0.02 * rng.standard_normal(shape)
    return w.astype(np.float32)


_PARAMS = {}


def _np_params(module, *shapes):
    """Seeded numpy parameters of a flax module whose apply takes inputs
    of these (shape, dtype) pairs; the same tree of shapes gives the same
    arrays."""
    args = [jnp.zeros(shp, dt) for shp, dt in shapes]
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    sig = str(jax.tree_util.tree_map(lambda a: a.shape, tree))
    if sig not in _PARAMS:
        rng = np.random.default_rng(zlib.crc32(sig.encode()))
        _PARAMS[sig] = jax.tree_util.tree_map_with_path(
            lambda p, a: _leaf(p, a.shape, rng), tree)
    return _PARAMS[sig]


def _pc2_params(jpc2):
    params = {"feature_model": {}, "point_cloud_model": _np_params(
        jpc2.backbone, ((1, N, jpc2.in_channels), jnp.float32),
        ((1,), jnp.int32))}
    if jpc2.cfg.image_feature_model != "identity":
        params["feature_model"] = _np_params(jpc2.feature_model,
                                             ((1, S, S, 3), jnp.float32))
    return params


def _pvd_params(jpvd):
    return _np_params(jpvd.backbone, ((1, N, 3), jnp.float32),
                      ((1,), jnp.int32))


_denoise = jax.jit(lambda jpc2, *args: jpc2.denoise(*args),
                   static_argnums=0)


@functools.lru_cache(maxsize=None)
def _jax_pc2(items):
    """One JAX PC2 a configuration, so its jitted calls compile once."""
    return JaxPC2(JaxCfg(**dict(BASE, **dict(items))), sa_blocks=TINY_SA,
                  fp_blocks=TINY_FP)


def _pair(**overrides):
    """(JAX PC2, its params, the port's PC2 on the CPU with them)."""
    jpc2 = _jax_pc2(tuple(sorted(overrides.items())))
    params = _pc2_params(jpc2)
    cfg = ProjectionConfig(**dict(BASE, **overrides))
    vit = TINY_VIT if cfg.image_feature_model == "tiny" else None
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, vit_kwargs=vit, device="cpu")
    specs = getattr(pc2.backbone, "specs", None)
    CJ.load_into(pc2, CJ.pc2_state_dict(params, specs,
                                        cfg.point_cloud_model))
    return jpc2, params, pc2


def _batch(seed, mask=False):
    """A numpy batch: image, and mask + its distance transform."""
    rng = np.random.default_rng(seed)
    out = {"image": rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)}
    if mask:
        yy, xx = np.mgrid[:S, :S]
        m = ((yy - S / 2) ** 2 + (xx - S / 2.5) ** 2 < (S / 3) ** 2)
        out["mask"] = np.broadcast_to(m[None, ..., None],
                                      (B, S, S, 1)).astype(np.float32)
        out["distance_transform"] = compute_distance_transform(out["mask"])
    return out


def _both(batch):
    """The numpy batch as JAX and port batches (with cameras)."""
    jcam, tcam = _cams(B)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    jb["camera"], tb["camera"] = jcam, tcam
    return jb, tb


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


# ------------------------------------------------------------ schedulers

@pytest.mark.parametrize("skip_prk", [False, True], ids=["prk", "skip_prk"])
def test_pndm_step_by_step(skip_prk):
    """The timesteps exactly; then each step from the same eps, the two
    trajectories within 1e-5."""
    jsched = JaxPNDM(np.asarray(linear_betas(1e-5, 8e-3)),
                     skip_prk_steps=skip_prk)
    psched = PNDMScheduler(linear_betas(1e-5, 8e-3), skip_prk_steps=skip_prk)
    ts = jsched.set_timesteps(10)
    np.testing.assert_array_equal(psched.set_timesteps(10), ts)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 3)).astype(np.float32)
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    sj, sp = jsched.init_state(x.shape), psched.init_state()
    for t in ts:
        eps = rng.standard_normal(x.shape).astype(np.float32)
        xj, sj = jsched.step(jnp.asarray(eps), int(t), xj, sj)
        xp, sp = psched.step(torch.from_numpy(eps), int(t), xp, sp)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-5)
    assert sp.counter == len(ts) == int(sj.counter)


def test_schedules_exact():
    for lo, hi, steps in ((1e-5, 8e-3, 1000), (1e-4, 2e-2, 100)):
        np.testing.assert_array_equal(
            custom_betas(lo, hi, steps),
            jax_custom_betas(lo, hi, num_train_timesteps=steps))
    for kind in ("linear", "warm0.1", "warm0.5"):
        np.testing.assert_array_equal(pvd_betas(kind, 1e-4, 2e-2, 1000),
                                      jax_pvd_betas(kind, 1e-4, 2e-2, 1000))
    for name in ("ddpm", "ddim", "pndm"):
        for schedule in ("linear", "custom"):
            got = make_scheduler(name, 1e-5, 8e-3, schedule)
            want = jax_make_scheduler(name, 1e-5, 8e-3, schedule)
            np.testing.assert_array_equal(
                np.asarray(got.alphas_cumprod, np.float32),
                np.asarray(want.alphas_cumprod))
            np.testing.assert_array_equal(got.set_timesteps(50),
                                          want.set_timesteps(50))
    with pytest.raises(ValueError):
        make_scheduler("ddpm", 1e-5, 8e-3, "cosine")


@pytest.mark.parametrize("var,clip", [("fixedsmall", True),
                                      ("fixedlarge", False),
                                      ("fixedlarge", True)])
def test_gaussian_variants(var, clip):
    """One p_sample with the same eps and noise within 1e-6; eps large
    enough that x0 is clipped at t 999."""
    betas = pvd_betas("warm0.1", 1e-4, 2e-2, 1000)
    jg = JaxGaussian(jax_pvd_betas("warm0.1", 1e-4, 2e-2, 1000),
                     model_var_type=var)
    tg = GaussianDiffusion(betas, model_var_type=var)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 3)).astype(np.float32)
    eps = (3 * rng.standard_normal((2, 64, 3))).astype(np.float32)
    for t in (999, 500, 1, 0):
        key = jax.random.PRNGKey(t)
        z = np.array(jax.random.normal(key, x.shape, jnp.float32))
        want = np.asarray(jg.p_sample(
            lambda xx, tt: jnp.asarray(eps), jnp.asarray(x),
            jnp.full((2,), t, jnp.int32), key, clip_denoised=clip))
        got = tg.p_sample(lambda xx, tt: torch.from_numpy(eps),
                          torch.from_numpy(x), t, torch.from_numpy(z),
                          clip_denoised=clip)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- conditioning

def test_surface_projection_nearest_exact():
    """Random points, exact duplicates (a tie in z: both win), points on
    a half-pixel (rounded half to even) and behind the camera (zeros)."""
    rng = np.random.default_rng(7)
    pts = (rng.standard_normal((2, 256, 3)) * 0.4).astype(np.float32)
    pts[:, 10:20] = pts[:, 0:10]                        # duplicates
    # x_ndc = x at z 0 (focal 2, camera 2 ahead): pixel (16(1-x)-1)/2
    pts[:, 20:26, 0] = [0.5, 0.25, -0.25, 0.125, 0.375, -0.625]
    pts[:, 20:26, 1] = [0.5, -0.125, 0.25, 0.0, -0.5, 0.75]
    pts[:, 20:26, 2] = 0.0
    pts[:, 30:40, 2] = -2.5                             # behind the camera
    fmap = rng.uniform(1, 2, (2, S, S, 4)).astype(np.float32)
    jcam, tcam = _cams(2)
    want = np.asarray(jax_proj(jnp.asarray(pts), jcam, jnp.asarray(fmap),
                               radius=0.3, splat="nearest"))
    got = surface_projection(torch.from_numpy(pts), tcam,
                             torch.from_numpy(fmap), radius=0.3,
                             splat="nearest").numpy()
    won = (want != 0).any(-1)
    assert 0 < won.sum() < won.size
    assert not won[:, 30:40].any()
    np.testing.assert_array_equal(got, want)


def test_distance_transform_copy():
    rng = np.random.default_rng(2)
    masks = rng.uniform(0, 1, (3, 24, 24)) > 0.7
    masks[0] = False
    masks[1, 4:18, 6:20] = True
    for m in (masks, masks[..., None].astype(np.float32),
              masks.astype(np.uint8)):
        np.testing.assert_array_equal(compute_distance_transform(m),
                                      jdt.compute_distance_transform(m))


ACCOUNTINGS = {
    "mask_dt_six_outputs_nearest": dict(
        use_mask=True, use_distance_transform=True, predict_color=True,
        raster_splat="nearest"),
    "global_identity": dict(use_global_features=True),
    "vit_all": dict(image_feature_model="tiny", use_global_features=True),
    "vit_cls": dict(image_feature_model="tiny", use_local_features=False,
                    use_global_features=True),
}


@pytest.mark.parametrize("case", list(ACCOUNTINGS))
def test_conditioning_and_denoise(case):
    """The conditioning (local map within 1e-4, global features within
    1e-5 of their largest entry) and one denoise on converted params
    within 1e-4 of the largest output."""
    overrides = ACCOUNTINGS[case]
    jpc2, params, pc2 = _pair(**overrides)
    assert pc2.in_channels == jpc2.in_channels
    assert pc2.out_channels == jpc2.out_channels
    assert pc2.local_cond_channels == jpc2.local_cond_channels
    jb, tb = _both(_batch(5, mask="mask" in case))
    jcond = jpc2.conditioning_map(params, jb["image"], jb.get("mask"),
                                  jb.get("distance_transform"))
    tcond = pc2.batch_conditioning(tb)
    if pc2.cfg.use_global_features:
        assert isinstance(tcond, Conditioning)
        _close(tcond.global_feats.numpy(), jcond.global_feats, 1e-5)
        _close(tcond.local_map.numpy(), jcond.local_map, 1e-4)
    else:
        _close(tcond.numpy(), jcond, 1e-4)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    t = np.array([517, 3], np.int32)
    want = _denoise(jpc2, params, jnp.asarray(x), jnp.asarray(t),
                    jb["camera"], jcond)
    with torch.no_grad():
        got = pc2.denoise(torch.from_numpy(x), torch.from_numpy(t).long(),
                          tb["camera"], pc2.prepare_cond(tcond))
    assert got.shape == (B, N, pc2.out_channels)
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("backbone", ["simple", "pvcnnplusplus"])
def test_backbone_mux(backbone, monkeypatch):
    """The simple model and PVCNN2++ (its inner PVCNN2 at the tiny blocks
    on both sides) on converted params, one denoise within 1e-4 of the
    largest output."""
    monkeypatch.setattr(jsimple, "PVCNN2", _tiny_pvcnn2)
    jpc2, params, pc2 = _pair(point_cloud_model=backbone)
    jb, tb = _both(_batch(8))
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    t = np.array([17, 901], np.int32)
    jcond = jpc2.conditioning_map(params, jb["image"])
    want = _denoise(jpc2, params, jnp.asarray(x), jnp.asarray(t),
                    jb["camera"], jcond)
    with torch.no_grad():
        got = pc2.denoise(torch.from_numpy(x), torch.from_numpy(t).long(),
                          tb["camera"],
                          pc2.prepare_cond(pc2.batch_conditioning(tb)))
    _close(got.numpy(), want, 1e-4)


# --------------------------------------------------------------- voxel ops

def test_precontract_voxel_helpers():
    """run_counts_sorted exact; scatter_mean_contributions and
    tap_shift_sum within 1e-6 (float32 sums in the same order)."""
    rng = np.random.default_rng(11)
    coords = (rng.standard_normal((2, 200, 3)) * 0.3).astype(np.float32)
    coords[:, 100:150] = coords[:, :50]                 # shared voxels
    feats = rng.standard_normal((2, 200, 54)).astype(np.float32)
    jctx = jvox.make_voxel_context(jnp.asarray(coords), 4)
    tctx = ops.make_voxel_context(torch.from_numpy(coords), 4)
    np.testing.assert_array_equal(ops.run_counts_sorted(tctx).numpy(),
                                  np.asarray(jvox.run_counts_sorted(jctx)))
    grid = ops.scatter_mean_contributions(torch.from_numpy(feats), tctx, 4)
    want = jvox.scatter_mean_contributions(jnp.asarray(feats), jctx, 64)
    np.testing.assert_allclose(grid.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    g = rng.standard_normal((2, 5, 5, 5, 27 * 2)).astype(np.float32)
    np.testing.assert_allclose(
        ops.tap_shift_sum(torch.from_numpy(g), 2).numpy(),
        np.asarray(jconv_wide.tap_shift_sum(jnp.asarray(g), 2)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("case", ["local", "global"])
def test_precontracted_denoise(case):
    """One denoise through the precontracted stage-0 conv within 1e-4 of
    JAX's precontracted denoise and of the port's own plain denoise (the
    same sum reassociated)."""
    overrides = dict(precontract=True)
    if case == "global":
        overrides["use_global_features"] = True
    jpc2, params, pc2 = _pair(**overrides)
    assert pc2.precontract_enabled
    jb, tb = _both(_batch(12))
    jcond = jpc2.conditioning_map(params, jb["image"])
    tcond = pc2.batch_conditioning(tb)
    jpre = jpc2.precontract_cond(params, jcond)
    tpre = pc2.maybe_precontract(tcond)
    assert isinstance(tpre, PrecontractedCond)
    assert (tpre.gtap is None) == (case == "local")
    np.testing.assert_allclose(
        tpre.comb_map.numpy(),
        np.asarray(jpre.comb_map).reshape(tpre.comb_map.shape), rtol=1e-5,
        atol=1e-5)
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    t = np.array([250, 800], np.int32)
    want = np.asarray(_denoise(jpc2, params, jnp.asarray(x),
                               jnp.asarray(t), jb["camera"], jpre))
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t).long(),
                tb["camera"])
        got = pc2.denoise(*args, tpre).numpy()
        plain = pc2.denoise(*args, pc2.prepare_cond(tcond)).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-4)


# -------------------------------------------------------------- sampling

class SampleKeyNoise(NoiseProvider):
    """Replays `bdm_tpu.samplers.PC2Model.sample`'s keys: split(key) ->
    (k_init, k_loop); without evolutions step j draws from split(k_loop,
    n)[j]; with them segment i takes k_loop, sub = split(k_loop) and step
    j of it split(sub, n)[j]. `PVDModel.sample`'s are the first case."""

    def __init__(self, key, segments):
        self.k_init, k_loop = jax.random.split(key)
        self.subs = [k_loop]
        if segments:
            self.subs = []
            for _ in range(segments):
                k_loop, sub = jax.random.split(k_loop)
                self.subs.append(sub)

    def initial(self, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.k_init, shape, jnp.float32)))

    def step(self, branch, i, j, n_steps, shape):
        k = jax.random.split(self.subs[i], n_steps)[j]
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))


SAMPLES = {"ddpm": dict(scheduler="ddpm"),
           "ddim_eta_evolutions": dict(scheduler="ddim", eta=0.5,
                                       return_sample_every_n_steps=4),
           "pndm": dict(scheduler="pndm")}


@pytest.mark.parametrize("case", list(SAMPLES))
def test_pc2_sample(case):
    """The full reverse loop, 8 inference steps (PNDM: 12 Runge-Kutta
    and 5 multistep steps), JAX keys replayed: within 1e-3, the
    evolutions too."""
    kw = SAMPLES[case]
    jpc2, params, pc2 = _pair()
    jb, tb = _both(_batch(14))
    key = jax.random.PRNGKey(21)
    want = jpc2.sample(params, jb, key, num_points=N, num_inference_steps=8,
                       **kw)
    every = kw.get("return_sample_every_n_steps", -1)
    got = pc2.sample(tb, N, noise=SampleKeyNoise(
        key, -(-8 // every) if every > 0 else 0), num_inference_steps=8, **kw)
    if every > 0:
        (got, got_evo), (want, want_evo) = got, want
        assert got_evo.shape == (B, 2, N, 3)
        np.testing.assert_allclose(got_evo.numpy(), np.asarray(want_evo),
                                   rtol=0, atol=1e-3)
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_sampling_refusals_and_batch_conditioning():
    """PNDM refuses windows and evolutions; a window without `cond`
    builds it from the batch."""
    _, _, pc2 = _pair()
    _, tb = _both(_batch(15))
    with pytest.raises(NotImplementedError):
        pc2.sample(tb, N, noise=NoiseProvider(device="cpu"),
                   scheduler="pndm", num_inference_steps=8,
                   return_sample_every_n_steps=2)
    x = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(0))
    z = torch.zeros(B, N, 3)
    with pytest.raises(ValueError, match="pndm"):
        pc2.interaction_sample(x, tb, 8, 4, 8, lambda j, n: z, "pndm")
    cond = pc2.prepare_cond(pc2.batch_conditioning(tb))
    a = pc2.interaction_sample(x, tb, 8, 4, 8, lambda j, n: z, "ddim",
                               eta=0.5)
    b = pc2.interaction_sample(x, tb, 8, 4, 8, lambda j, n: z, "ddim",
                               eta=0.5, cond=cond)
    assert torch.equal(a, b)


@pytest.mark.parametrize("var,schedule", [("fixedsmall", "linear"),
                                          ("fixedlarge", "warm0.5")])
def test_pvd_sample(var, schedule):
    """Unconditional generation over a 6-step chain, JAX keys replayed:
    within 1e-3."""
    kw = dict(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
              num_timesteps=6, schedule_type=schedule, model_var_type=var)
    jpvd = JaxPVD(**kw)
    params = _pvd_params(jpvd)
    pvd = PVDModel(device="cpu", **kw)
    CJ.load_into(pvd, CJ.pvd_state_dict(params, pvd.model.specs))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jpvd.sample(params, (B, N, 3), key))
    got = pvd.sample((B, N, 3), SampleKeyNoise(key, 0)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_bdm_blending_precontract_mask_dt():
    """BDM-Blending with `precontract=True`, the mask and its distance
    transform in the batch, DDPM 8 steps, two interior milestones, JAX
    keys replayed: within 1e-3."""
    jpc2, params, pc2 = _pair(precontract=True, use_mask=True,
                              use_distance_transform=True)
    jpvd = JaxPVD(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    pvd_params = _pvd_params(jpvd)
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    CJ.load_into(pvd, CJ.pvd_state_dict(pvd_params, pvd.model.specs))
    jb, tb = _both(_batch(16, mask=True))
    milestones, roll, steps = [8, 7, 5, 3, 0], 1, 8
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_blending(
        jpc2, params, jpvd, pvd_params, jb, key, num_points=N,
        milestones=milestones, roll_step=roll, num_inference_steps=steps))
    got = bdm_blending(pc2, pvd, tb, num_points=N, milestones=milestones,
                       roll_step=roll,
                       noise=JaxKeyNoise(key, len(milestones) - 1),
                       num_inference_steps=steps).numpy()
    assert got.shape == (B, N, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
