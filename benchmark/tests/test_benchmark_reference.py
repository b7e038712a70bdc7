"""The reference against the port at tiny widths on the CPU, float32 on
both sides: the same weights load into both under the checkpoints' keys,
and a sampling run's steps and blends, and a training run's losses,
gradients and changes, agree to float32 rounding."""

import torch

from benchmark.tests import tiny

CPU = torch.device("cpu")


def _run(cell, seed=3):
    import time
    return cell.driver().run(cell, seed, 0.0, False, False, CPU,
                             time.perf_counter())


def test_sampling_steps_agree():
    out = _run(tiny.cell("sample", window=[0]))
    got = {c.name: c.value for c in out.checks}
    assert got["exact"] == 0
    # the largest over the compared steps: where float32 rounding moves
    # a point across a voxel's or a ball's edge, a step reads up to ~1e-4
    for k in ("pc2_step", "pvd_step", "blend"):
        assert got[k] < 3e-4, got
    # the slice, one step of each of its five PC2 and two PVD chains, and
    # both blends
    assert out.steps == 176 and out.attempted == 10


def test_training_steps_agree():
    out = _run(tiny.cell("train"))
    got = {c.name: c.value for c in out.checks}
    assert got["exact"] == 0
    # grad is in units of the bfloat16 reference's own gap
    assert got["loss"] < 1e-6 and got["grad"] < 1e-2 and got["change"] < 1e-4


def test_weights_load_into_both_strictly():
    from benchmark.drivers import common
    from benchmark.reference.models import PC2, PVD
    cfg = tiny.cell("sample").config
    for kind, ref_cls, prog in (("pc2", PC2, common.pc2_program),
                                ("pvd", PVD, common.pvd_program)):
        sd = common.seeded_state(kind, cfg, 9, CPU)
        ref = ref_cls(cfg[kind])
        ref.load_state_dict(sd, strict=True)
        prog(cfg, CPU).load_state_dict(sd, strict=True)
        again = common.seeded_state(kind, cfg, 9, CPU)
        assert all(torch.equal(sd[k], again[k]) for k in sd)
