"""The merging driver at tiny widths on the CPU: the program at float32
agrees with the reference step by step and over every fusion step, the
run compares what it should, and the control (the reference at fp8 in the
program's place) comes out not correct under the cell's limits."""

import time

import torch

from benchmark.tests import tiny_merging

CPU = torch.device("cpu")


def test_steps_and_fusions_agree_and_the_control_fails():
    cell = tiny_merging.cell(window=[0])
    out = cell.driver().run(cell, 3, 0.0, False, True, CPU,
                            time.perf_counter())
    got = {c.name: c.value for c in out.checks}
    assert got["exact"] == 0
    for k in ("pc2_step", "pvd_step", "fuse_step", "fuse_pvd"):
        assert got[k] < 3e-4, got
    # the head slice: 142 PC2, 30 PVD and 2 fusion steps; one step of each
    # of its five PC2 and two PVD chains, both rolls' last steps before
    # each fusion, and both fusions
    assert out.steps == 174 and out.attempted == 1 + 7 + 2 * 2 + 2
    assert not all(c.ok for c in out.notes["control"]["fp8"])
    assert out.kind == "sample" and out.flops > 0
