"""The control, the reference at fp8 in the program's place, comes out
not correct under each cell's limits, while the program passes: at tiny
widths on the CPU, and (marked `cuda`) at the cells' own sizes on the
card with a short window."""

import time

import pytest
import torch

from benchmark import manifest
from benchmark.tests import tiny


def _run(cell, dev, seconds=0.0, seed=23):
    return cell.driver().run(cell, seed, seconds, False, True, dev,
                             time.perf_counter())


def _control_fails(out) -> bool:
    return not all(c.ok for c in out.notes["control"]["fp8"])


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_control_fails_tiny(kind):
    cell = tiny.cell(kind)
    out = _run(cell, torch.device("cpu"))
    assert all(c.ok for c in out.checks)
    assert _control_fails(out)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", manifest.workloads())
def test_control_fails_at_the_cells_size(card, workload):
    cell = manifest.load(workload)
    out = _run(cell, card, seconds=1.0)
    assert all(c.ok for c in out.checks), [(c.name, c.value)
                                           for c in out.checks]
    assert _control_fails(out)
