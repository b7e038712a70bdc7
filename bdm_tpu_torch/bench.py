"""The port's measurement helpers that other code reads: the operations of
a forward (`forward_flops`), the check of a run's kernel launches against
its path (`check_launches`), the card's name and power limit (`smi_line`)
and its peak rates (`PEAK_FLOPS`).

The port is measured by the benchmark (`python3 -m benchmark.run`);
`chip_smoke.py` and `tools/cli_breakdown.py` use these helpers on the
card, and the benchmark's operation count is held against
`forward_flops`.
"""

from __future__ import annotations

import subprocess

# Peak dense rates a second by card name (NVIDIA's data sheet)
H100 = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100: {"bf16": 989e12, "f32": 67e12}}


def _layer_flops(module, args, out) -> int:
    """The operations of one call of a layer `forward_flops` counts, from
    the shapes of its input (`args[0]`) or output; 0 for the others."""
    import torch.nn as nn
    from bdm_tpu_torch.models.feature_model import _Attn
    from bdm_tpu_torch.models.layers import SE, Attention, Conv1x1
    from bdm_tpu_torch.models.pvcnn import VoxConv
    x = args[0] if args else None
    if isinstance(module, (VoxConv, Conv1x1, nn.Linear)):
        # rows x (Cin x Cout, and 27 taps for the conv)
        return 2 * (x.numel() // x.shape[-1]) * module.weight.numel()
    if isinstance(module, SE):
        b = x.shape[0]
        return 2 * b * sum(module.fc[i].weight.numel() for i in (0, 2))
    if isinstance(module, (Attention, _Attn)):
        b, s, c = x.shape
        return 4 * b * s * s * c
    if isinstance(module, nn.Conv2d):
        return 2 * out.numel() * module.weight[0].numel()
    return 0


def forward_flops(module, call) -> int:
    """The operations (2 a multiply-add) of one `call()` that runs
    `module`, counted by forward hooks on its layers from the shapes each
    sees:
      voxel conv (3x3x3 SAME on the whole grid): 2 B R^3 27 Cin Cout;
      dense and shared-MLP layers (Conv1x1, nn.Linear): 2 rows in out;
      squeeze-excitation: its two bias-free dense layers on (B, C);
      attention, voxel or global (q k^T and p v): 4 B S^2 C, and the
      ViT's: 4 B T^2 D; its patch embedding 2 out Cin p^2.
    Left out: elementwise work, norms, softmax, gathers, the scatter-mean,
    devoxelization, the three-neighbour blend, the geometry kernels'
    distances and, under `precontract`, stage 0's precontracted taps."""
    import torch
    total = [0]

    def note(m, args, out):
        total[0] += _layer_flops(m, args, out)

    hooks = [m.register_forward_hook(note) for m in module.modules()]
    try:
        with torch.inference_mode():
            call()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def check_launches(counts: dict, paths: dict, expected: set,
                   float32: bool) -> dict:
    """Every kernel of `expected` launched and no other; no plain version
    ran on the card; every attention and conv3d launch took the
    tensor-core kernel ("tc", conv3d's "wgmma"), on a float32 path the
    CUDA-core one ("simt"); every blend the vector kernel (the models'
    widths are multiples of 8). Raises AssertionError on a breach; -> the
    launches, those of the kernels with paths also by kernel
    ("conv3d_wgmma", ...)."""
    for name, (launches, plain) in counts.items():
        if (launches > 0) != (name in expected):
            raise AssertionError(f"kernel {name} launched {launches} times; "
                                 f"the path's kernels are {sorted(expected)}")
        if plain:
            raise AssertionError(f"the plain version of {name} ran on the "
                                 f"card {plain} times")
    out = {k: v[0] for k, v in counts.items()}
    wrong = {"tc", "wgmma", "scalar"} if float32 else {"simt", "scalar"}
    for name, by in paths.items():
        if sum(by.values()) != out[name]:
            raise AssertionError(f"{name}: {by} launches by kernel, "
                                 f"{out[name]} in all")
        if any(by[k] for k in wrong & set(by)):
            raise AssertionError(f"{name} launched {by}: the wrong kernel "
                                 f"for a {'float32' if float32 else 'bf16'} "
                                 f"path")
        out.update({f"{name}_{k}": v for k, v in by.items()})
    return out


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
