"""The three-NN kernel of this tree against another tree's, on the card.

    python -m bdm_tpu_torch.tools.compare_three_nn OTHER/bdm_tpu_torch/csrc

OTHER is another checkout of the repository (for example the parent
commit, unpacked with `git archive`). Its `three_nn.cu` is built with its own
`common.cuh` into a library of its own under `bdm_tpu_torch/_build/`; both
`bdm_three_nn` entry points are timed at the five FP shapes of the paths
(B 8; PC2's four levels and PVD's first at twice the width, centres by
FPS), 10 launches back to back behind a busy matmul (`chip_smoke.timed_ms`),
in the order other, this, this, other, and held exact against the plain
version. Prints one JSON line with the card's name and power limit. Run it
from the repository's root: it imports `chip_smoke`.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

from bdm_tpu_torch import ops
from bdm_tpu_torch.bench import smi_line
from bdm_tpu_torch.ops.cuda import _lib, fps, three_nn
from chip_smoke import timed_ms   # run from the repository root

SHAPES = [(4096, 1024), (1024, 256), (256, 64), (64, 16), (2048, 1024)]


def build_other(csrc: Path) -> ctypes.CDLL:
    lib = _lib.build_source(csrc / "three_nn.cu")
    lib.bdm_three_nn.argtypes = list(_lib._SIGNATURES["bdm_three_nn"])
    return lib


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    libs = {"other": build_other(Path(sys.argv[1]).resolve()),
            "this": _lib.library()}
    g = torch.Generator().manual_seed(0)
    pts = {4096: (torch.randn(8, 4096, 3, generator=g) * 0.3).cuda()}
    for n, m in SHAPES[:4]:
        pts[m] = ops.gather(pts[n], fps.furthest_point_sample(pts[n], m)
                            ).contiguous()
    pts[2048] = pts[4096][:, :2048].contiguous()
    half = ops.gather(pts[2048], fps.furthest_point_sample(pts[2048], 1024)
                      ).contiguous()
    cases = {f"N{n}_M{m}": (pts[n], half if n == 2048 else pts[m])
             for n, m in SHAPES}

    def run(lib, p, c):
        b, n, _ = p.shape
        idx = torch.empty((b, n, 3), dtype=torch.int32, device="cuda")
        w = torch.empty((b, n, 3), dtype=torch.float32, device="cuda")
        rc = lib.bdm_three_nn(p.data_ptr(), c.data_ptr(), idx.data_ptr(),
                              w.data_ptr(), b, n, c.shape[1],
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"bdm_three_nn: CUDA error {rc}")
        return idx, w

    exact = {}
    for key, (p, c) in cases.items():
        pi, pw = three_nn.three_nn_plain(p, c)
        exact[key] = {name: all(torch.equal(a, b) for a, b in
                                zip(run(lib, p, c), (pi, pw)))
                      for name, lib in libs.items()}
    ms = {key: {"other": [], "this": []} for key in cases}
    for name in ("other", "this", "this", "other"):
        for key, (p, c) in cases.items():
            ms[key][name].append(
                timed_ms(lambda: run(libs[name], p, c), inner=10))
    print(json.dumps({"card": smi_line(), "ms_back_to_back": ms,
                      "speedup": {k: statistics.mean(v["other"])
                                  / statistics.mean(v["this"])
                                  for k, v in ms.items()},
                      "exact": exact}))
    return 0 if all(all(v.values()) for v in exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
