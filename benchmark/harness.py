"""What every driver hands back, and the result line built from it."""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from benchmark.trace import Summary

# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "bdm_tpu")


@dataclass
class Check:
    """One number compared, with its limit (0 for an exact comparison)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    kind: str                       # "sample" or "train"
    setup_s: float
    window_s: float
    steps: int                      # steps completed in the window
    flops: float                    # operations of the window's steps
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    memory_peak_bytes: int
    bound_s_per_step: float = 0.0   # least time of a step's own kernels
    peak_flops: float = 0.0
    trace: Optional[Summary] = None
    notes: Dict[str, object] = field(default_factory=dict)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache the program or its libraries keep goes
    to a fixed directory of the checkout (the port builds its own kernels
    into `bdm_tpu_torch/_build/`, also inside the checkout)."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


@contextlib.contextmanager
def quiet_host():
    """The window's host: Python's cyclic collector frozen and off (no
    pause of the issuing thread for a collection), and the calling thread
    held on one core of its own (no migration between cores), both undone
    on exit."""
    cores = os.sched_getaffinity(0)
    gc.collect()
    gc.freeze()
    gc.disable()
    os.sched_setaffinity(0, {max(cores)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)
        gc.enable()
        gc.unfreeze()


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({k.split(".", 1)[0] for k in names} & set(FORBIDDEN))


def result(outcome: Outcome, metrics: Dict[str, dict], device: dict,
           trace: bool) -> dict:
    failed = sum(not c.ok for c in outcome.checks)
    out = {"correct": failed == 0, "attempted": outcome.attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        out["breakdown"] = {"device_ops": outcome.trace.device_ops,
                            "idle_gaps": outcome.trace.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return out
