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
from bdm_tpu.utils import convert_torch as CT
from bdm_tpu_torch.models.feature_model import FeatureModel
from bdm_tpu_torch.models.pvcnn import PVCNN2
from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig, PVDModel
from bdm_tpu_torch.utils import convert_jax as CJ
from tests.test_models import TINY_FP, TINY_SA

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
