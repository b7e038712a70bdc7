"""Build and load the Hopper kernels of `bdm_tpu_torch/csrc/`.

The sources are compiled with `nvcc` for `sm_90a`, one compiler process
per source and all at once, and linked into one shared library with a
plain C interface, loaded with `ctypes`. The build runs at the first
launch (or an explicit `build()`), lands in `bdm_tpu_torch/_build/` (listed
in `.gitignore`) and is keyed on a hash of the sources, so an edited kernel
is rebuilt and an unchanged one is reused.

Nothing here runs at import: without `nvcc` or a GPU the package imports
and only a launch raises.

Every launch goes through `launch`, which counts it in `ledger` under its
kernel (the `KERNELS` key of `ops.cuda`), and under its path where the
wrapper names one (`PATHS`). The wrappers count there too the calls of
their plain forms on CUDA tensors (`plain_call`) and conv3d its weight
packs.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "bdm_fps": (_P, _P, _P, _I, _I, _I, _P),
    "bdm_ball_query": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    "bdm_three_nn": (_P, _P, _P, _P, _I, _I, _I, _P),
    "bdm_interp": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bdm_scatter_mean": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "bdm_scatter_sum": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    "bdm_conv3d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "bdm_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bdm_groupnorm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                      _P),
    "bdm_groupnorm_stats": (_P, _P, _I, _I, _I, _I, _I, _P),
    "bdm_groupnorm_apply": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                            _I, _I, _P),
    "bdm_devox": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the sources' own rules, which the wrappers mirror
    "bdm_attention_path": (_I, _I, _I),
    "bdm_conv3d_path": (_I, _I, _I, _I),
    "bdm_conv3d_planes": (_I, _I, _I, _I, _I, _I),
    "bdm_conv3d_n_tile": (_I, _I),
    "bdm_fps_threads": (_I,),
    "bdm_fps_points": (_I,),
    "bdm_three_nn_lanes": (_I, _I, _I),
    "bdm_three_nn_step": (_I,),
    "bdm_interp_threads": (),
    "bdm_interp_rows": (),
    "bdm_scatter_mean_vec": (_I, _I, _I),
    "bdm_scatter_mean_lanes": (_I, _I, _I),
    "bdm_groupnorm_chunks": (_I, _I, _I, _I),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# entry point that launches -> (its kernel, the launches of one call)
LAUNCHES = {
    "bdm_fps": ("fps", 1),
    "bdm_ball_query": ("ball_query", 1),
    "bdm_three_nn": ("three_nn", 1),
    "bdm_interp": ("interp_mm", 1),
    "bdm_scatter_mean": ("scatter_mean", 1),
    "bdm_scatter_sum": ("scatter_sum", 1),
    "bdm_conv3d": ("conv3d", 1),
    "bdm_attention": ("attention", 1),
    "bdm_groupnorm": ("groupnorm", 2),     # statistics, apply
    "bdm_groupnorm_stats": ("groupnorm", 1),
    "bdm_groupnorm_apply": ("groupnorm", 1),
    "bdm_devox": ("devox", 1),
}
# kernel -> the kernels of its source a wrapper chooses between:
# tensor cores ("tc": `mma.sync`; "wgmma": Hopper's warpgroup products) or
# CUDA cores ("simt"); 16-byte channel groups ("vec") or one channel
# ("scalar")
PATHS = {"attention": ("tc", "simt"), "conv3d": ("wgmma", "simt"),
         "interp_mm": ("vec", "scalar")}

# (kernel, "launches" | a path | "plain" | "packs") -> count
ledger = collections.Counter()

_lib = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    return BUILD_DIR / f"libbdm_kernels_{_source_hash()}.so"


def _run_all(cmds) -> str:
    """Run the nvcc commands side by side; raise with the compiler's output
    if one failed, else return the joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
              for cmd, proc, out in zip(cmds, procs, outs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I",
             str(CSRC)]
    if verbose:
        flags.append("-Xptxas=-v")
    # build under temporary names, then rename: concurrent builds never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = {src: os.path.join(tmp, src.stem + ".o")
                for src in sorted(CSRC.glob("*.cu"))}
        log = _run_all([[nvcc, *flags, "-c", str(src), "-o", obj]
                        for src, obj in objs.items()])
        lib = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
                          *objs.values()]])
        if verbose:
            print(log)
        os.replace(lib, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.bdm_error_string.argtypes = [ctypes.c_int]
        lib.bdm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args, path: str | None = None) -> None:
    """Call one kernel entry point on the current stream; raise if CUDA
    refused the launch, else count it in `ledger` (and under `path`, the
    kernel of the source the call took)."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.bdm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    kernel, n = LAUNCHES[name]
    ledger[kernel, "launches"] += n
    if path is not None:
        ledger[kernel, path] += n


def plain_call(kernel: str, t: torch.Tensor) -> None:
    """Count a call of `kernel`'s plain form if it runs on the card."""
    if t.is_cuda:
        ledger[kernel, "plain"] += 1


def check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of one of `dtypes`
    with `ndim` dimensions."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
