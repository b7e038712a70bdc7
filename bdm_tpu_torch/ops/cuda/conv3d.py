"""3x3x3 SAME voxel convolution: the `csrc/conv3d.cu` kernel and its plain
version.

Replaces `conv3d_ms_pallas` and `conv3d_mm_pallas`
(bdm_tpu/ops/pallas/conv3d.py): channel-last (B, R, R, R, Cin) in float32
or bfloat16, weights rounded to the input type (as the TPU path casts its
kernel), float32 accumulation and bias, output in the input type.
Weights keep the reference layout (Cout, Cin, 3, 3, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bdm_tpu_torch.ops.cuda import _lib

launches = 0
plain_cuda_calls = 0


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, R, Cin), weight (Cout, Cin, 3, 3, 3), bias (Cout,)."""
    global plain_cuda_calls
    if x.is_cuda:
        plain_cuda_calls += 1
    w = weight.to(x.dtype).float()
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w, bias.float(),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def gemm_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (27 * Cin, Cout), tap-major rows
    (kd, kh, kw, ci): the layout the kernel reads."""
    cout, cin = weight.shape[:2]
    return (weight.to(dtype).permute(2, 3, 4, 1, 0)
            .reshape(27 * cin, cout).contiguous())


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias)
    _lib.check(x, "x", tuple(_lib.DTYPE_CODES), 5)
    b, r = x.shape[:2]
    cin = x.shape[-1]
    cout = weight.shape[0]
    if (x.shape[1:4] != (r, r, r) or weight.shape != (cout, cin, 3, 3, 3)
            or bias.shape != (cout,) or weight.device != x.device
            or bias.device != x.device):
        raise ValueError(f"conv3d: x {tuple(x.shape)} on {x.device}, weight "
                         f"{tuple(weight.shape)} on {weight.device}, bias "
                         f"{tuple(bias.shape)} on {bias.device}")
    w = gemm_weight(weight, x.dtype)
    bf = bias.float().contiguous()
    out = torch.empty((b, r, r, r, cout), dtype=x.dtype, device=x.device)
    _lib.launch("bdm_conv3d", x.data_ptr(), w.data_ptr(), bf.data_ptr(),
                out.data_ptr(), b, r, cin, cout, _lib.DTYPE_CODES[x.dtype])
    launches += 1
    return out
