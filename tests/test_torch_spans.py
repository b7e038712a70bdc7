"""The port's spans (`bdm_tpu_torch.utils.spans`) on tiny models on the
CPU: where they open, counted from the module tree; that every name the
models emit is in `NAMES` and every name in `NAMES` is emitted; that with
recording off a span is one shared no-op a profiler never sees; and that
recording changes no output bit. Torch only."""

import torch

from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.models.fusion import PVCNNFuse
from bdm_tpu_torch.models.layers import Attention, GroupNormCL
from bdm_tpu_torch.models.pvcnn import (PVCNN2, PointNetFP, PointNetSA,
                                        PVConv)
from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
from bdm_tpu_torch.tools.span_cost import measure, user_spans
from bdm_tpu_torch.utils import spans
from tests.torch_ranks import TINY_FP, TINY_SA

torch.set_num_threads(1)

B, N, S = 2, 64, 16


def _inputs(c, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, c, generator=g) * 0.5, torch.tensor([517, 3])


def _pvcnn2():
    net = PVCNN2(embed_dim=8, extra_feature_channels=5, sa_blocks=TINY_SA,
                 fp_blocks=TINY_FP, classifier_init_scale=None)
    net.reset_parameters(0)
    return net


def _fuse():
    net = PVCNNFuse(out_channels=3, embed_dim=8, extra_feature_channels=5,
                    sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    net.reset_parameters(0)
    return net


def _pc2_window():
    """A tiny PC2 and a call of two DDPM steps of `interaction_sample`."""
    pc2 = PC2Model(ProjectionConfig(image_size=S,
                                    image_feature_model="identity",
                                    raster_point_radius=0.3,
                                    point_cloud_model_embed_dim=8),
                   TINY_SA, TINY_FP, device="cpu")
    pc2.reset_parameters(0)
    g = torch.Generator().manual_seed(1)
    cam = PerspectiveCamera(torch.eye(3).expand(B, 3, 3).clone(),
                            torch.tensor([[0.0, 0.0, 1.5]] * B),
                            torch.full((B, 2), 2.1875), torch.zeros(B, 2))
    batch = {"image": torch.rand(B, S, S, 3, generator=g), "camera": cam}
    x = torch.randn(B, N, 3, generator=g)
    z = torch.randn(B, N, 3, generator=g)
    return pc2, lambda: pc2.interaction_sample(x, batch, 8, 6, 8,
                                               lambda j, n: z)


def _names(fn):
    """(fn(), the span names a user-scope profiler kept, in order)."""
    kept = []
    with spans.recording(), user_spans(kept):
        out = fn()
    return out, [k[0] for k in kept]


def _count(module, kind):
    return sum(isinstance(m, kind) for m in module.modules())


def test_forward_emits_a_span_per_module():
    net = _pvcnn2()
    x, t = _inputs(8)
    with torch.no_grad():
        _, names = _names(lambda: net(x, t))
    want = {"network": 1,
            "pvconv.voxelize": _count(net, PVConv),
            "pvconv.se": _count(net, PVConv),
            "pvconv.devoxelize": _count(net, PVConv),
            "groupnorm": _count(net, GroupNormCL),
            "attention": _count(net, Attention),
            "sa.group": _count(net, PointNetSA),
            "fp.interpolate": _count(net, PointNetFP)}
    assert want["pvconv.devoxelize"] > 0 and want["attention"] > 0
    assert {n: names.count(n) for n in want} == want
    # one voxel context a stage with convs, shared by its PVConvs
    stages = [s for s in list(net.sa_layers) + list(net.fp_layers)
              if any(isinstance(m, PVConv) for m in s.modules())]
    assert names.count("voxel.context") == len(stages)
    assert names[0] == "network"


def test_every_name_is_in_the_table_and_every_entry_is_emitted():
    _, window = _pc2_window()
    _, pc2_names = _names(window)
    net = _fuse()
    x, t = _inputs(8)
    with torch.no_grad():
        _, fuse_names = _names(lambda: net(x, x[..., :3], t))
    assert pc2_names.count("network") == 2
    assert pc2_names.count("pc2.condition") == 2
    assert pc2_names.count("pc2.update") == 2
    assert fuse_names.count("network") == 1
    emitted = set(pc2_names) | set(fuse_names)
    assert emitted == set(spans.NAMES)
    layers = {"model step: models/, conditioning/, diffusion/",
              "entry loop: samplers/ and train/",
              "point ops and glue: ops/*.py and PyTorch, cuDNN calls",
              "kernels: ops/cuda/ and csrc/"}
    assert set(spans.NAMES.values()) <= layers


def test_fusion_spans_once_each_inside_network():
    net = _fuse()
    x, t = _inputs(8)
    kept = []
    with torch.no_grad(), spans.recording(), user_spans(kept):
        net(x, x[..., :3], t)
    spans_of = {}
    for name, ts, dur in kept:
        spans_of.setdefault(name, []).append((ts, ts + dur))
    (lo, hi), = spans_of["network"]
    for name in ("fusion.pvd_tower", "fusion.project"):
        (a, b), = spans_of[name]
        assert lo <= a <= b <= hi, name
    # off: nothing recorded
    off = []
    with torch.no_grad(), user_spans(off):
        net(x, x[..., :3], t)
    assert off == []


def test_off_is_one_shared_noop_a_profiler_never_sees():
    assert spans.span("network") is spans.span("groupnorm")
    net = _pvcnn2()
    x, t = _inputs(8)
    kept = []
    with torch.no_grad(), user_spans(kept):
        net(x, t)
    assert kept == []
    with spans.recording():
        assert spans.span("network") is not spans.span("network")
        with spans.recording():
            pass
        assert spans.span("network") is not spans.span("network")
    assert spans.span("network") is spans.span("network")


def test_recording_restores_the_state_after_an_error():
    try:
        with spans.recording():
            raise KeyError("x")
    except KeyError:
        pass
    assert spans.span("network") is spans.span("pc2.update")


def test_outputs_bit_equal_with_recording_on_and_off():
    pc2, window = _pc2_window()
    off = window()
    on, names = _names(window)
    assert names and torch.equal(on, off)
    net = _fuse()
    x, t = _inputs(8, seed=3)
    with torch.no_grad():
        off = net(x, x[..., :3], t)
        on, names = _names(lambda: net(x, x[..., :3], t))
    assert names and torch.equal(on, off)


def test_span_cost_tool():
    """The tool behind the off-path cost: one span kept a call under the
    profiler, nothing kept and the recording state restored after."""
    out = measure(2000)
    assert out["profiled_spans"] == 2000 and out["calls"] == 2000
    assert out["off_us"] < out["on_us"]
    assert spans.span("network") is spans.span("network")
