"""What `benchmark.run` and the reference load, compared by whole
top-level module names: never JAX or the JAX package (`bdm_tpu`, a prefix
of the port's name), and the reference nothing of the port."""

import json
import subprocess
import sys

from benchmark import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "bdm_tpu"}

RUN_TINY = """
import json, sys, time, torch
from benchmark import harness, run
from benchmark.tests import tiny
c = tiny.cell("sample")
c.driver().run(c, 3, 0.0, False, False, torch.device("cpu"),
               time.perf_counter())
t = tiny.cell("train")
t.driver().run(t, 3, 0.0, False, False, torch.device("cpu"),
               time.perf_counter())
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""

REFERENCE = """
import json, sys
import benchmark.reference.diffusion, benchmark.reference.geometry
import benchmark.reference.models, benchmark.reference.precision
import benchmark.reference.pvcnn, benchmark.reference.training
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                              "PYTHONPATH": str(manifest.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(RUN_TINY)
    assert "bdm_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level(REFERENCE)
    assert not mods & (FORBIDDEN | {"bdm_tpu_torch"})


def test_harness_check_compares_whole_names():
    from benchmark.harness import forbidden_modules
    assert forbidden_modules(["bdm_tpu_torch", "bdm_tpu_torch.ops",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["bdm_tpu.ops.pallas", "jaxlib.xla_client",
                              "flax"]) == ["bdm_tpu", "flax", "jaxlib"]
