"""The frozen counting code on shapes worked out by hand, and against the
port's own hook-based count (`bdm_tpu_torch.bench.forward_flops`)."""

import json

import pytest
import torch

from benchmark import counting, manifest
from benchmark.tests import tiny

MS = 1e-3


def _cfg():
    with open(manifest.ROOT / "benchmark" / "configs"
              / "bdm-blending.json") as f:
        return json.load(f)


def test_one_stage_by_hand():
    """One SA stage with one PVConv (Cin 6, Cout 8, R 2, no attention) over
    N 10 points to M 4 centres of K 2, MLP (3 + 8) -> 8; one FP stage
    (8 + 3 + E 2 -> 8, no conv); head 8 -> 128 -> 3; B 1."""
    net = counting.pvcnn2([[[8, 1, 2], [4, 0.5, 2, [8]]]], [[[8], None]],
                          3, 2, 10, use_att=False)
    pvconv = (2 * 8 * 27 * 6 * 8 + 2 * 8 * 27 * 8 * 8   # two 3x3x3 convs
              + 2 * 2 * 8 * 1                           # SE 8 -> 1 -> 8
              + 2 * 10 * 6 * 8)                         # point features
    sa_mlp = 2 * 4 * 2 * 11 * 8
    fp_mlp = 2 * 10 * 13 * 8
    head = 2 * 10 * 8 * 128 + 2 * 10 * 128 * 3
    embedf = 2 * 2 * 2 * 2
    assert counting.pvcnn2_flops(net, 1) == (pvconv + sa_mlp + fp_mlp + head
                                             + embedf)


def test_vit_by_hand():
    """Image 32, patch 16 (4 patches + CLS = 5 tokens), D 8, one block."""
    patch = 2 * 8 * 4 * 3 * 16 * 16
    block = (2 * 5 * 8 * 24 + 4 * 5 * 5 * 8 + 2 * 5 * 8 * 8
             + 2 * 2 * 5 * 8 * 32)
    assert counting.vit_flops(1, 32, 16, 8, 1) == patch + block


def test_production_counts_match_the_recorded_ones():
    """PC2, PVD and the ViT at B 8, N 4096: 829.1, 649.7 and 73.6 GFLOP a
    forward (the figures the port's bench recorded, PERF.md)."""
    c = _cfg()
    p, v = c["pc2"], c["pvd"]
    pc2 = counting.pvcnn2(p["sa_blocks"], p["fp_blocks"], 387, 64, 4096)
    pvd = counting.pvcnn2(v["sa_blocks"], v["fp_blocks"], 0, 64, 4096)
    assert round(counting.pvcnn2_flops(pc2, 8) / 1e9, 1) == 829.1
    assert round(counting.pvcnn2_flops(pvd, 8) / 1e9, 1) == 649.7
    assert round(counting.vit_flops(8, 224, 16, 384, 12) / 1e9, 1) == 73.6


@pytest.mark.parametrize("kernel, want_ms", [
    # chip_smoke.py phase a's bounds at B 8 (PERF.md's kernel table)
    ("fps", 0.00500), ("three_nn", 0.00451), ("attention", 0.03474),
    ("interp", 0.00336)])
def test_kernel_bounds_by_hand(kernel, want_ms):
    b, n, m, c = 8, 4096, 1024, 128
    launch = {
        "fps": counting.Launch("fps", b * n * 12 + b * m * 4,
                               b * (m - 1) * n * 10, "f32"),
        "three_nn": counting.Launch("three_nn", 0, b * n * m * 9, "f32"),
        "attention": counting.Launch("attention", 0, 4 * b * n * n * 64,
                                     "bf16"),
        "interp": counting.Launch("interp", 2 * b * n * 12 + b * m * c * 2
                                  + b * n * c * 2, b * n * c * 6, "f32"),
    }[kernel]
    assert launch.bound_s / MS == pytest.approx(want_ms, abs=5e-6)


def test_production_launches():
    """A bf16 PC2 forward at B 8: 28 conv3d, 14 scatter-mean, 4 FPS, 4 ball
    query, 4 three-NN, 2 blends, 1 attention (PERF.md's launch counts);
    the stage-0 conv 390 -> 32 at R 32 bounded at 0.17863 ms and the
    stage-0 scatter-mean of C 390 at 0.06902 ms; a training step adds the
    two blends' scatter-sums."""
    c = _cfg()["pc2"]
    net = counting.pvcnn2(c["sa_blocks"], c["fp_blocks"], 387, 64, 4096)
    launches = counting.kernel_launches(net, 8, True)
    names = [x.kernel for x in launches]
    assert {k: names.count(k) for k in set(names)} == {
        "conv3d": 28, "scatter_mean": 14, "fps": 4, "ball_query": 4,
        "three_nn": 4, "interp": 2, "attention": 1}
    assert launches[1].bound_s / MS == pytest.approx(0.17863, abs=5e-6)
    assert launches[0].bound_s / MS == pytest.approx(0.06902, abs=5e-6)
    train = [x.kernel for x in counting.kernel_launches(net, 16, True, True)]
    assert train.count("scatter_sum") == 2
    assert "interp" not in [x.kernel for x in counting.kernel_launches(
        net, 8, False)]


@pytest.mark.parametrize("kind", ["pc2", "pvd"])
def test_matches_the_ports_hook_count(kind):
    """The analytic count equals the port's `forward_flops` (forward hooks
    on its layers) on the tiny configuration."""
    from bdm_tpu_torch.bench import forward_flops
    from benchmark.drivers import common
    cfg = tiny.cell("sample").config
    dev = torch.device("cpu")
    b, n = 2, 64
    x = torch.randn(b, n, 3)
    t = torch.full((b,), 500)
    if kind == "pc2":
        model = common.pc2_program(cfg, dev)
        c = cfg["pc2"]
        cond = model.prepare_cond(model.conditioning_map(torch.rand(
            b, 16, 16, 3)))
        from bdm_tpu_torch.conditioning import PerspectiveCamera
        cam = PerspectiveCamera(torch.eye(3).expand(b, 3, 3),
                                torch.tensor([[0.0, 0.0, 1.5]] * b),
                                torch.full((b, 2), 2.1875),
                                torch.zeros(b, 2))
        got = forward_flops(model.backbone,
                            lambda: model.denoise(x, t, cam, cond))
        net = counting.pvcnn2(c["sa_blocks"], c["fp_blocks"],
                              3 + c["vit"]["embed_dim"], c["embed_dim"], n)
    else:
        model = common.pvd_program(cfg, dev)
        c = cfg["pvd"]
        got = forward_flops(model.model, lambda: model.model(x, t))
        net = counting.pvcnn2(c["sa_blocks"], c["fp_blocks"], 0,
                              c["embed_dim"], n)
    assert counting.pvcnn2_flops(net, b) == got
