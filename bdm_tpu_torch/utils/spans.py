"""Named spans around the parts of a sampler step, for a profiler to read.

`span(name)` is a context for one part of the step. It records nothing,
and costs one check of a module-level flag, unless `recording()` is on:
then it is `torch.profiler.record_function(name)`, which a running
profiler keeps as a `user_annotation` event. `NAMES` maps each span to
the layer it belongs to (`PERF.md` §3)."""

from __future__ import annotations

import contextlib

import torch

_LOOP = "entry loop: samplers/ and train/"
_MODEL = "model step: models/, conditioning/, diffusion/"
_GLUE = "point ops and glue: ops/*.py and PyTorch, cuDNN calls"
_KERNELS = "kernels: ops/cuda/ and csrc/"
NAMES = {"network": _MODEL, "pc2.condition": _MODEL, "pc2.update": _LOOP,
         "fusion.pvd_tower": _MODEL, "fusion.project": _MODEL,
         "voxel.context": _GLUE, "pvconv.voxelize": _GLUE,
         "pvconv.se": _GLUE, "pvconv.devoxelize": _GLUE,
         "groupnorm": _KERNELS, "attention": _KERNELS, "sa.group": _KERNELS,
         "fp.interpolate": _KERNELS}

_ON = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the part of the step called `name` (a key of
    `NAMES`)."""
    if not _ON:
        return _OFF
    return torch.profiler.record_function(name)


def is_recording() -> bool:
    """Whether spans record now (inside `recording()`)."""
    return _ON


@contextlib.contextmanager
def recording():
    """Spans record inside this block; the previous state comes back on
    exit."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was
