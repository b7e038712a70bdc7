"""3x3x3 SAME voxel convolution: the `csrc/conv3d.cu` kernel and its plain
version.

Replaces every voxel conv of bdm_tpu/ops/pallas/conv3d.py: `conv3d_pallas`
(any R, per-slab im2col), `conv3d_wg_pallas` (whole grid a batch element),
`conv3d_ms_pallas` (Cin <= 256, taps by roll or by pad) and
`conv3d_mm_pallas` (Cin > 256, prepadded or unpadded input). They tile one
sum differently for the TPU; here one kernel computes it: channel-last
(B, R, R, R, Cin) in float32 or bfloat16, any R, any Cin, weights rounded
to the input type (as the TPU path casts its kernel), float32 accumulation
and bias, output in the input type. Weights keep the reference layout
(Cout, Cin, 3, 3, 3).

`conv3d` is differentiable (`_conv3d_bwd`): the cotangents of a plain conv
whose weights were cast to the grid's dtype, returned in the primal dtypes
(the weights' and the bias's gradients float32), through one
`aten.convolution_backward` on channel-last views, without TF32.
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


def _forward(x, weight, bias):
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


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.to(x.dtype).permute(0, 4, 1, 2, 3),
                x.permute(0, 4, 1, 2, 3), weight.to(x.dtype),
                [weight.shape[0]], [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
                [0, 0, 0], 1, list(ctx.needs_input_grad))
        return (None if dx is None else dx.permute(0, 2, 3, 4, 1),
                None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(ctx.bias_dtype))


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    return _Conv3d.apply(x, weight, bias)
