"""The bf16 blend kernel of this tree against another tree's on the card,
and the gap before the blend inside a production forward.

    python -m bdm_tpu_torch.tools.compare_interp [OTHER/bdm_tpu_torch/csrc]

OTHER is another checkout of the repository (for example the parent
commit, unpacked with `git archive`). Its `interp.cu` is built with its own
`common.cuh` into a library of its own under `bdm_tpu_torch/_build/`. At the
two shapes of the paths (B 8; N 4096 <- M 1024, C 128 and N 1024 <- M 256,
C 256; indices and weights from three-NN on FPS centres) both `bdm_interp`
entry points are held bit for bit against the plain version, then timed in
the order other, this, this, other:
  * on the card, 20 launches back to back behind a busy matmul
    (`chip_smoke.timed_ms`);
  * on the host clock, the cost of enqueueing one call of the C entry point
    through ctypes (the launch path of each source, without the Python
    wrapper): rounds of 200 calls with no synchronise inside a round, the
    median of 5 rounds after 100 calls of warm-up. 200 pending launches
    stay far below the card's queue, so the host's cost is what is timed.
The Python wrapper `interp.interp_mm` of this tree is timed on the host the
same way. Last, 10 of PC2's bf16 denoises at production widths (B 8,
N 4096, `profile_step.forward_calls`) are traced: for every launch of the blend, the
device event before it and the gap between the two
(`profile_step.gaps_before`); a gap of 0 or less means the blend was
enqueued while the kernel before it ran, where the early launch can act.
Prints one JSON line with the card's name and power limit. Run it from the
repository's root: it imports `chip_smoke`.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from bdm_tpu_torch import ops
from bdm_tpu_torch.bench import smi_line
from bdm_tpu_torch.ops.cuda import _lib, fps, interp, three_nn
from bdm_tpu_torch.tools import profile_step
from chip_smoke import timed_ms   # run from the repository root

SHAPES = [(4096, 1024, 128), (1024, 256, 256)]


def build_other(csrc: Path) -> ctypes.CDLL:
    lib = _lib.build_source(csrc / "interp.cu")
    lib.bdm_interp.argtypes = list(_lib._SIGNATURES["bdm_interp"])
    return lib


def cases() -> dict:
    g = torch.Generator().manual_seed(0)
    pts = {4096: (torch.randn(8, 4096, 3, generator=g) * 0.3).cuda()}
    for n, m in ((4096, 1024), (1024, 256)):
        pts[m] = ops.gather(pts[n], fps.furthest_point_sample(pts[n], m)
                            ).contiguous()
    out = {}
    for n, m, c in SHAPES:
        i, w = three_nn.three_nn(pts[n], pts[m])
        f = torch.randn(8, m, c, generator=g).to("cuda", torch.bfloat16)
        out[f"N{n}_M{m}_C{c}"] = (i, w, f)
    return out


def enqueue_us(call, calls: int = 200, rounds: int = 5) -> float:
    """The host's time to enqueue one `call()`: the median over `rounds`
    of `calls` calls with no synchronise, after 100 of warm-up."""
    for _ in range(100):
        call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def main() -> int:
    if len(sys.argv) > 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    libs = {"this": _lib.library()}
    if len(sys.argv) == 2:
        libs["other"] = build_other(Path(sys.argv[1]).resolve())
    stream = torch.cuda.current_stream().cuda_stream

    def entry(lib, i, w, f, out):
        """-> a call of `lib`'s C entry point on these tensors."""
        b, n, _ = i.shape
        m, c = f.shape[1:]
        args = (i.data_ptr(), w.data_ptr(), f.data_ptr(), out.data_ptr(), b,
                n, m, c, stream)

        def call():
            rc = lib.bdm_interp(*args)
            if rc:
                raise RuntimeError(f"interp: CUDA error {rc}")
        return call

    data = cases()
    exact, ms, host_us, wrapper_us = {}, {}, {}, {}
    for key, (i, w, f) in data.items():
        plain = interp.interp_mm_plain(i, w, f)
        exact[key] = {}
        for name, lib in libs.items():
            out = torch.empty_like(plain)
            entry(lib, i, w, f, out)()
            exact[key][name] = torch.equal(out, plain)
        ms[key] = {name: [] for name in libs}
        host_us[key] = {name: [] for name in libs}
        wrapper_us[key] = enqueue_us(lambda: interp.interp_mm(i, w, f))
    order = ("other", "this", "this", "other") if "other" in libs else (
        "this",)
    for name in order:
        for key, (i, w, f) in data.items():
            out = torch.empty((*i.shape[:2], f.shape[2]), dtype=f.dtype,
                              device=f.device)
            call = entry(libs[name], i, w, f, out)
            ms[key][name].append(timed_ms(call, inner=20))
            host_us[key][name].append(enqueue_us(call))
    pc2_forward = profile_step.forward_calls()["pc2_forward"]
    result = {"card": smi_line(), "ms_back_to_back": ms, "exact": exact,
              "enqueue_us_c_entry": host_us,
              "enqueue_us_wrapper_this": wrapper_us,
              "pc2_bf16_forward_gaps": profile_step.gaps_before(
                  pc2_forward, "interp_kernel", steps=10)}
    if "other" in libs:
        result["speedup"] = {k: statistics.mean(v["other"])
                             / statistics.mean(v["this"])
                             for k, v in ms.items()}
    print(json.dumps(result))
    return 0 if all(all(v.values()) for v in exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
