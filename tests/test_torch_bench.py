"""What is left of the port's measurement helpers in `bdm_tpu_torch.bench`:
the synthetic batch against `__graft_entry__._synthetic_batch`, the
operation count against `torch.utils.flop_counter.FlopCounterMode`, the
launch check, and the samplers' schedule as forward hooks count it.

The operation count (`bench.forward_flops`) and `FlopCounterMode` count
the same products on the plain CPU forward: convolutions, dense layers and
the attention products. Both leave out elementwise work, norms, softmax,
gathers, the scatter-mean, devoxelization and the three-neighbour blend
(the float32 gather form here), and the geometry kernels' distances; the
tolerance is 1e-6 relative (they should agree exactly).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bdm_tpu_torch import bench
from bdm_tpu_torch.models import FeatureModel
from bdm_tpu_torch.samplers import NoiseProvider, bdm_blending, bdm_merging
from bdm_tpu_torch.tools.standins import production_models, synthetic_batch

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the production schedule of BDM-Blending and BDM-Merging
MILESTONES = [1000, 968, 936, 872, 128, 64, 32, 0]
ROLL_STEP = 16


def test_synthetic_batch_is_bench_py_batch():
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _synthetic_batch
    want = _synthetic_batch(3, 50, 16, np.random.default_rng(0))
    got = synthetic_batch(3, 50, 16, np.random.default_rng(0))
    for key in ("points", "image"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    for f in ("R", "T", "focal_length", "principal_point"):
        np.testing.assert_array_equal(getattr(got["camera"], f).numpy(),
                                      np.asarray(getattr(want["camera"], f)))


def _counted(module, call):
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        call()
    got = bench.forward_flops(module, call)
    return got, fc.get_total_flops()


@pytest.mark.parametrize("model", ["pc2", "pvd", "fusion", "vit"])
def test_forward_flops_equals_flop_counter(model):
    pc2, pvd, merge = production_models(0, "no", False, "cpu", True)
    data = synthetic_batch(2, 64, 16, np.random.default_rng(1))
    cond = pc2.prepare_cond(pc2.batch_conditioning(data))
    x, cam = data["points"], data["camera"]
    t = torch.full((2,), 500)
    if model == "vit":
        fm = FeatureModel(32, vit_kwargs=dict(patch_size=8, embed_dim=16,
                                              depth=2, num_heads=2))
        image = torch.rand(2, 32, 32, 3)
        got, want = _counted(fm, lambda: fm(image))
        # patch embedding, 2 blocks of qkv, attention, proj, MLP
        d, tokens, b = 16, 17, 2
        assert got == b * (2 * 16 * 3 * 64 * d + 2 * (
            2 * tokens * d * 3 * d + 4 * tokens ** 2 * d
            + 2 * tokens * d * d + 2 * 2 * tokens * d * 4 * d))
    else:
        module, call = {
            "pc2": (pc2.backbone, lambda: pc2.denoise(x, t, cam, cond)),
            "pvd": (pvd.model, lambda: pvd.model(x, t)),
            "fusion": (merge.fusion, lambda: merge.predict(
                x, x, 500, cam, cond, "fusion_nstep"))}[model]
        got, want = _counted(module, call)
    assert want > 0
    assert abs(got - want) <= 1e-6 * want, (got, want)


def _stub_forwards(pc2, pvd, merge):
    """Backbones that return zeros: the samplers' loops run without the
    networks' work; the forward hooks still see every call."""
    pc2.backbone.forward = lambda inputs, t, pre_tap=None: torch.zeros(
        inputs.shape[:2] + (3,))
    pvd.model.forward = lambda x, t: torch.zeros_like(x)
    merge.fusion.forward = lambda x, prior, t, mode: torch.zeros_like(prior)


@pytest.mark.parametrize("sampler,want", [
    ("blending", {"pc2": 1000, "pvd": 80, "fusion": 0, "vit": 1}),
    ("merging", {"pc2": 995, "pvd": 75, "fusion": 5, "vit": 1})])
def test_forward_counter_reads_the_schedule(sampler, want):
    """MILESTONES and roll 16: BDM-B runs 920 steps of the recon segments
    and 5 rolls of 16 of each branch; BDM-M's rolls stop one step short,
    the fusion step takes it."""
    pc2, pvd, merge = production_models(0, "no", False, "cpu", True)
    _stub_forwards(pc2, pvd, merge)
    data = synthetic_batch(1, 4, 16, np.random.default_rng(0))
    nets = dict(pc2=pc2.backbone, pvd=pvd.model, fusion=merge.fusion,
                vit=pc2.feature_model)
    counts = dict.fromkeys(nets, 0)
    hooks = [m.register_forward_hook(
        lambda *_, k=k: counts.__setitem__(k, counts[k] + 1))
        for k, m in nets.items()]
    kw = dict(batch=data, num_points=4, milestones=MILESTONES,
              roll_step=ROLL_STEP, noise=NoiseProvider(0, "cpu"),
              num_inference_steps=1000)
    if sampler == "merging":
        bdm_merging(merge, pc2, pvd, **kw)
    else:
        bdm_blending(pc2, pvd, **kw)
    for h in hooks:
        h.remove()
    assert counts == want


def test_check_launches_raises_on_a_breach():
    counts = {"fps": (3, 0), "conv3d": (4, 0), "attention": (0, 0)}
    paths = {"conv3d": {"wgmma": 4, "simt": 0},
             "attention": {"tc": 0, "simt": 0}}
    out = bench.check_launches(counts, paths, {"fps", "conv3d"}, False)
    assert out["conv3d_wgmma"] == 4 and out["fps"] == 3
    # a bf16 conv on the CUDA cores is the wrong kernel too
    with pytest.raises(AssertionError, match="wrong kernel"):
        bench.check_launches(counts, dict(paths, conv3d={"wgmma": 3,
                                                         "simt": 1}),
                             {"fps", "conv3d"}, False)
    with pytest.raises(AssertionError, match="attention"):
        bench.check_launches(counts, paths, {"fps", "conv3d", "attention"},
                             False)
    with pytest.raises(AssertionError, match="wrong kernel"):
        bench.check_launches(counts, paths, {"fps", "conv3d"}, True)
    with pytest.raises(AssertionError, match="plain version"):
        bench.check_launches(dict(counts, fps=(3, 1)), paths,
                             {"fps", "conv3d"}, False)


def test_check_launches_refuses_groupnorm_in_its_plain_form():
    """GroupNorm trains and shards through its kernel pair: a path whose
    norms ran the plain form on the card, or never launched the kernel,
    breaks the check like any other kernel."""
    counts = {"conv3d": (4, 0), "groupnorm": (126, 0)}
    paths = {"conv3d": {"wgmma": 4, "simt": 0}}
    out = bench.check_launches(counts, paths, {"conv3d", "groupnorm"}, False)
    assert out["groupnorm"] == 126
    with pytest.raises(AssertionError, match="plain version of groupnorm"):
        bench.check_launches(dict(counts, groupnorm=(126, 63)), paths,
                             {"conv3d", "groupnorm"}, False)
    with pytest.raises(AssertionError, match="kernel groupnorm launched 0"):
        bench.check_launches(dict(counts, groupnorm=(0, 63)), paths,
                             {"conv3d", "groupnorm"}, False)


def test_check_launches_refuses_the_scalar_blend():
    """The models' widths are multiples of 8: a path whose blend took the
    one-channel kernel has the wrong kernel; its vector launches count by
    kernel."""
    counts = {"interp_mm": (2, 0), "conv3d": (1, 0)}
    paths = {"conv3d": {"wgmma": 1, "simt": 0},
             "interp_mm": {"vec": 2, "scalar": 0}}
    out = bench.check_launches(counts, paths, {"interp_mm", "conv3d"}, False)
    assert out["interp_mm_vec"] == 2 and out["interp_mm_scalar"] == 0
    with pytest.raises(AssertionError, match="wrong kernel"):
        bench.check_launches(counts, dict(paths, interp_mm={"vec": 1,
                                                            "scalar": 1}),
                             {"interp_mm", "conv3d"}, False)
    with pytest.raises(AssertionError, match="in all"):
        bench.check_launches(counts, dict(paths, interp_mm={"vec": 1,
                                                            "scalar": 0}),
                             {"interp_mm", "conv3d"}, False)

