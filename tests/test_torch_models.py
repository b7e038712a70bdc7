"""`bdm_tpu_torch` networks against `bdm_tpu` on the same weights.

JAX parameters are initialised from a seed, carried into the port by
`bdm_tpu_torch.utils.convert_jax`, and both forwards run at float32 on the
CPU. Tolerances: PVCNN2 within 1e-4 of max|out| and the ViT within 1e-4
(float32 sums taken in another order through ~20 layers); the weight round
trip through `bdm_tpu/utils/convert_torch.py` is bit-exact (transposes
only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu.models import feature_model as jfm
from bdm_tpu.models.pvcnn import PVCNN2 as JaxPVCNN2
from bdm_tpu.models.pvcnn import build_pvcnn2_specs as jax_build_specs
from bdm_tpu.utils import convert_torch as CT
from bdm_tpu_torch.models.feature_model import FeatureModel
from bdm_tpu_torch.models.fusion import PVCNNFuse
from bdm_tpu_torch.models.pvcnn import PVCNN2, PVConv, build_pvcnn2_specs
from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig, PVDModel
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

TINY_VIT = dict(patch_size=4, embed_dim=16, depth=2, num_heads=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _jax_pvcnn2(extra, seed, n=64):
    cis = 1e-6 if extra else None
    jm = JaxPVCNN2(out_channels=3, embed_dim=8, extra_feature_channels=extra,
                   sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   classifier_init_scale=cis)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 3 + extra)).astype(np.float32)
    x[..., :3] *= 0.5
    t = np.array([517, 3], np.int32)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                       jnp.asarray(x), jnp.asarray(t)))
    # a visible head, so the comparison sees the whole network
    head = params["params"]["decoder"]["classifier_out"]
    head["kernel"] = (rng.standard_normal(head["kernel"].shape) * 0.1
                      ).astype(np.float32)
    return jm, params, x, t


@pytest.mark.parametrize("extra", [5, 0], ids=["pc2", "pvd"])
def test_pvcnn2_tiny_parity(extra):
    jm, params, x, t = _jax_pvcnn2(extra, seed=extra + 1)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    tm = PVCNN2(out_channels=3, embed_dim=8, extra_feature_channels=extra,
                sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    CJ.load_into(tm, CJ.pvcnn2_state_dict(params, tm.specs))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("width,res", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("extra", [387, 0], ids=["pc2", "pvd"])
def test_specs_match_jax(extra, width, res):
    """The channel accounting with both multipliers, field by field, at
    the published blocks."""
    import dataclasses
    want = jax_build_specs(extra_feature_channels=extra,
                           width_multiplier=width,
                           voxel_resolution_multiplier=res)
    got = build_pvcnn2_specs(extra_feature_channels=extra,
                             width_multiplier=width,
                             voxel_resolution_multiplier=res)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.channels_sa_features == 512 * width
    assert got.sa_stages[0].convs[0].resolution == 32 * res
    if width == 2:   # the conv wider than 256 the TPU sends to conv3d_mm
        assert got.fp_stages[0].convs[0].out_channels == 512


def test_pvcnn2_wide_parity():
    """`width_multiplier=2` and `voxel_resolution_multiplier=2` through the
    whole network against the JAX one, same tolerance as the plain tiny
    network."""
    kw = dict(out_channels=3, embed_dim=8, extra_feature_channels=0,
              sa_blocks=TINY_SA, fp_blocks=TINY_FP, width_multiplier=2,
              voxel_resolution_multiplier=2)
    jm = JaxPVCNN2(classifier_init_scale=None, **kw)
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 64, 3)) * 0.5).astype(np.float32)
    t = np.array([517, 3], np.int32)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(13),
                                       jnp.asarray(x), jnp.asarray(t)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    tm = PVCNN2(classifier_init_scale=None, **kw)
    assert (tm.specs.sa_stages[0].convs[0].resolution
            == jm.specs().sa_stages[0].convs[0].resolution == 8)
    CJ.load_into(tm, CJ.pvcnn2_state_dict(params, tm.specs))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale


def test_dropout_layers():
    """Both dropouts of the reference (p = 0.1, after the first voxel conv
    and before the head) run in `train()` with the rate and the 1/(1-p)
    scaling, and are the identity in `eval()`, the mode every model leaves
    its constructor in; the state_dict has no key for them."""
    kw = dict(out_channels=3, embed_dim=8, extra_feature_channels=5,
              sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    tm = PVCNN2(**kw)
    fuse = PVCNNFuse(**kw)
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    assert not tm.training and not fuse.training and not pvd.training
    drops = [m for m in tm.modules() if isinstance(m, torch.nn.Dropout)]
    n_convs = sum(isinstance(m, PVConv) for m in tm.modules())
    assert len(drops) == n_convs + 1 and all(d.p == 0.1 for d in drops)
    assert all(d.p == 0.25 for d in PVCNN2(dropout=0.25, **kw).modules()
               if isinstance(d, torch.nn.Dropout))
    assert not any("voxel_layers.3" in k or "classifier.1" in k
                   for k in tm.state_dict())
    tm.reset_parameters(0)
    with torch.no_grad():
        tm.classifier[2].weight.normal_(
            0, 0.1, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((2, 64, 8)) * 0.5).astype(
        np.float32))
    t = torch.tensor([517, 3])
    with torch.no_grad():
        a, b = tm(x, t), tm(x, t)
        assert torch.equal(a, b)                    # eval: no randomness
        tm.train()
        torch.manual_seed(0)
        c = tm(x, t)
        torch.manual_seed(1)
        d = tm(x, t)
        tm.eval()
    assert not torch.equal(c, d) and not torch.equal(c, a)
    # the layers themselves: rate and scaling
    conv = next(m for m in tm.modules() if isinstance(m, PVConv))
    ones = torch.ones(200, 500)
    conv.train()
    torch.manual_seed(3)
    y = conv.voxel_layers[3](ones)
    conv.eval()
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 5e-3
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.9))
    assert torch.equal(conv.voxel_layers[3](ones), ones)


def test_pvcnn2_bf16_runs_close_to_f32():
    """The bf16 policy (bf16 grids and dense layers, f32 geometry, GN
    statistics and head) runs end to end; bf16 keeps ~3 significant
    digits and the error compounds through ~20 layers of random weights,
    so the bound is loose: 1e-1 of max|out|, as tests/test_models.py
    allows a whole bf16 PVConv."""
    _, params, x, t = _jax_pvcnn2(5, seed=7)
    outs = []
    for dt in (None, torch.bfloat16):
        tm = PVCNN2(out_channels=3, embed_dim=8, extra_feature_channels=5,
                    sa_blocks=TINY_SA, fp_blocks=TINY_FP, dtype=dt)
        CJ.load_into(tm, CJ.pvcnn2_state_dict(params, tm.specs))
        with torch.no_grad():
            outs.append(tm(torch.from_numpy(x),
                           torch.from_numpy(t).long()))
    assert outs[1].dtype == torch.float32
    assert torch.isfinite(outs[1]).all()
    scale = outs[0].abs().max()
    assert (outs[1] - outs[0]).abs().max() < 1e-1 * scale


def test_feature_model_tiny_parity(monkeypatch):
    monkeypatch.setitem(jfm.MODEL_KWARGS, "tiny", TINY_VIT)
    jm = jfm.FeatureModel(image_size=16, model_name="tiny")
    img = np.random.default_rng(3).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    params = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(img)))
    fm = FeatureModel(16, "tiny", TINY_VIT)
    CJ.load_into(fm, CJ.vit_state_dict(params["params"]["vit"], "model"))
    normed = ((img - np.asarray(jfm.IMAGENET_MEAN, np.float32))
              / np.asarray(jfm.IMAGENET_STD, np.float32))
    with torch.no_grad():
        tokens = fm.model(torch.from_numpy(normed)).numpy()
        feats = fm(torch.from_numpy(img)).numpy()
    want_tokens = jfm.VisionTransformer(**TINY_VIT).apply(
        {"params": params["params"]["vit"]}, jnp.asarray(normed))
    np.testing.assert_allclose(tokens, np.asarray(want_tokens), rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(jm.apply(params, jnp.asarray(img)))
    assert feats.shape == want.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(feats, want, rtol=1e-4, atol=1e-4)


def test_weight_round_trip_is_bit_exact(monkeypatch):
    """JAX -> port state_dict -> bdm_tpu convert_torch -> JAX, for PC2
    (backbone + ViT) and PVD."""
    monkeypatch.setitem(jfm.MODEL_KWARGS, "tiny", TINY_VIT)
    jfeat = jfm.FeatureModel(image_size=16, model_name="tiny")
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = {
        "feature_model": _np_tree(jax.jit(jfeat.init)(
            jax.random.PRNGKey(5), img)),
        # PC2 input: xyz + colours + 16 ViT features
        "point_cloud_model": _jax_pvcnn2(3 + 16, seed=5)[1],
    }
    cfg = ProjectionConfig(image_size=16, image_feature_model="tiny",
                           point_cloud_model_embed_dim=8)
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, vit_kwargs=TINY_VIT,
                   device="cpu")
    CJ.load_into(pc2, CJ.pc2_state_dict(params, pc2.backbone.specs))
    sd = {k: v.numpy() for k, v in pc2.state_dict().items()}
    specs = CT.build_pvcnn2_specs(TINY_SA, TINY_FP,
                                  extra_feature_channels=pc2.in_channels - 3)
    pre = "point_cloud_model.model"
    back = {
        "point_cloud_model": {"params": {
            "embedf": CT._timestep_mlp(sd, f"{pre}.embedf"),
            "encoder": CT.convert_encoder(sd, pre, specs),
            "decoder": CT.convert_decoder(sd, pre, specs)}},
        "feature_model": {"params": {"vit": CT.convert_vit(
            sd, "feature_model.model", TINY_VIT["depth"],
            TINY_VIT["num_heads"])}},
    }
    _assert_trees_equal(back, params)

    _, pvd_params, _, _ = _jax_pvcnn2(0, seed=6)
    pvd = PVDModel(embed_dim=8, sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                   device="cpu")
    CJ.load_into(pvd, CJ.pvd_state_dict(pvd_params, pvd.model.specs))
    sd = {k: v.numpy() for k, v in pvd.state_dict().items()}
    pspecs = CT.build_pvcnn2_specs(TINY_SA, TINY_FP, extra_feature_channels=0)
    back = {"params": {"embedf": CT._timestep_mlp(sd, "model.embedf"),
                       "encoder": CT.convert_encoder(sd, "model", pspecs),
                       "decoder": CT.convert_decoder(sd, "model", pspecs)}}
    _assert_trees_equal(back, pvd_params)


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, leaf in fa:
        ref = np.asarray(fb[path])
        assert leaf.shape == ref.shape, path
        assert leaf.dtype == ref.dtype, path
        np.testing.assert_array_equal(leaf, ref, err_msg=str(path))
