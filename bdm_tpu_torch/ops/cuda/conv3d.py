"""3x3x3 SAME voxel convolution: the `csrc/conv3d.cu` kernels and their
plain version.

Replaces every voxel conv of bdm_tpu/ops/pallas/conv3d.py: `conv3d_pallas`
(any R, per-slab im2col), `conv3d_wg_pallas` (whole grid a batch element),
`conv3d_ms_pallas` (Cin <= 256, taps by roll or by pad) and
`conv3d_mm_pallas` (Cin > 256, prepadded or unpadded input). They tile one
sum differently for the TPU; here the source computes it: channel-last
(B, R, R, R, Cin) in float32 or bfloat16, any R, any Cin, weights rounded
to the input type (as the TPU path casts its kernel), float32 accumulation
and bias, output in the input type. Weights keep the reference layout
(Cout, Cin, 3, 3, 3).

`kernel_path` says which kernel a call takes, by the grid's type alone:
bfloat16 grids the warpgroup tensor-core kernel ("wgmma": Hopper's
`wgmma.mma_async` fed through shared memory by a producer warp, the 27 taps
shifted views of a staged halo), float32 grids the CUDA-core ones ("simt").
Each reads the weights in a layout of its own (`pack_weight`,
`gemm_weight`), padded to the N tile of its kernel (`n_tile`); `packed`
makes that copy and the float32 bias once per weight and keeps it until the
parameter changes, so sampling packs once a layer and training once a step.

`conv3d` is differentiable (`_conv3d_bwd`): the cotangents of a plain conv
whose weights were cast to the grid's dtype, returned in the primal dtypes
(the weights' and the bias's gradients float32), through one
`aten.convolution_backward` on channel-last views, without TF32.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from bdm_tpu_torch.ops.cuda import _lib

CIN_STEP = 16   # the warpgroup kernel's chunk: the depth of one product
GEMM_CIN_STEP = 4   # the CUDA-core kernel's piece: 4 channels of one tap
GEMM_K_STEP = 16    # ... and its ring stage: 4 pieces
# `bdm_conv3d_path`'s codes
PATH_CODES = {"simt": 0, "wgmma": 2}


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, R, Cin), weight (Cout, Cin, 3, 3, 3), bias (Cout,)."""
    _lib.plain_call("conv3d", x)
    w = weight.to(x.dtype).float()
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w, bias.float(),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def kernel_path(dtype: torch.dtype, cin: int, cout: int, r: int) -> str:
    """Which kernel of `csrc/conv3d.cu` a CUDA grid of this type and shape
    launches (`bdm_conv3d_path` is the same rule in the source)."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def n_tile(dtype: torch.dtype, cout: int) -> int:
    """Output channels a block of the kernel that serves grids of `dtype`
    computes (`bdm_conv3d_n_tile`): the warpgroup kernel every channel up to
    128, the CUDA-core ones 32 or 64."""
    if dtype == torch.bfloat16:
        return 32 if cout <= 32 else (64 if cout <= 64 else 128)
    return 32 if cout <= 32 else 64


def padded(n: int, step: int) -> int:
    return -(-n // step) * step


def gemm_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (Kp, Cout_p), rows (tap, ci) with taps in
    (kd, kh, kw) order and the channels of a tap padded to Cin4 (a multiple
    of GEMM_CIN_STEP), Kp = 27 * Cin4 padded to a multiple of GEMM_K_STEP,
    Cout_p a multiple of the N tile, zeros in the padding: the layout the
    CUDA-core kernel reads."""
    cout, cin = weight.shape[:2]
    cin4 = padded(cin, GEMM_CIN_STEP)
    w = weight.detach().to(dtype).permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    out = w.new_zeros((padded(27 * cin4, GEMM_K_STEP),
                       padded(cout, n_tile(dtype, cout))))
    out[:27 * cin4].view(27, cin4, -1)[:, :cin, :cout] = w
    return out


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (Cout_p / NT, Cin_p / 16, 3, 9, 2, NT, 8)
    bfloat16: N tile, chunk of 16 input channels, kd, (kh, kw), 8-channel
    half of the chunk, output channel, channel; Cin_p a multiple of 16,
    Cout_p of the N tile NT, zeros in the padding. One (N tile, chunk, kd)
    is one contiguous stage of the warpgroup kernel's weight ring: for each
    of its 9 taps the B operand of one product, core matrices of 8 output
    channels x 8 input channels (128 bytes), the next 8 output channels 128
    bytes on, the second half of the chunk NT x 16 bytes on."""
    cout, cin = weight.shape[:2]
    nt = n_tile(torch.bfloat16, cout)
    cin_p, cout_p = padded(cin, CIN_STEP), padded(cout, nt)
    w = weight.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0)
    full = w.new_zeros((27, cin_p, cout_p))
    full[:, :cin, :cout] = w.reshape(27, cin, cout)
    # (kd, t9, chunk, half, e, ntile, n) -> (ntile, chunk, kd, t9, half, n, e)
    full = full.view(3, 9, cin_p // CIN_STEP, 2, 8, cout_p // nt, nt)
    return full.permute(5, 2, 0, 1, 3, 6, 4).contiguous()


def pack_bias(bias: torch.Tensor, cout_p: int) -> torch.Tensor:
    out = bias.new_zeros((cout_p,), dtype=torch.float32)
    out[:bias.shape[0]] = bias.detach().float()
    return out


# (id(weight), grid dtype) -> (weakrefs to the weight and the bias, their
# stamps, packed weights, packed bias); an entry goes when its weight dies
_packed = {}


def _stamp(t: torch.Tensor):
    return (t.data_ptr(), t._version, t.device, t.dtype)


def packed(weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype):
    """-> (weights, float32 bias) as the kernel that serves grids of `dtype`
    reads them, made at the first call and again after either tensor was
    written in place, replaced or moved (`data_ptr()`, `_version`). Tensors
    made under `inference_mode` carry no version: they are packed at every
    call. A write through `weight.data` bumps no version and is not seen:
    update parameters in place under `torch.no_grad()`, as the optimizers
    and `load_state_dict` do. Each copy made counts as one of conv3d's
    "packs" in the kernels' ledger."""
    cacheable = not (weight.is_inference() or bias.is_inference())
    key = (id(weight), dtype)
    if cacheable:
        stamp = (_stamp(weight), _stamp(bias))
        hit = _packed.get(key)
        if (hit is not None and hit[0]() is weight and hit[1]() is bias
                and hit[2] == stamp):
            return hit[3], hit[4]
    _lib.ledger["conv3d", "packs"] += 1
    cout, cin = weight.shape[:2]
    # one copy serves every grid size: the rule reads no R
    if kernel_path(dtype, cin, cout, 0) == "wgmma":
        w = pack_weight(weight)
        bf = pack_bias(bias, w.shape[0] * w.shape[5])
    else:
        w = gemm_weight(weight, dtype)
        bf = pack_bias(bias, w.shape[1])
    if cacheable:
        _packed[key] = (
            weakref.ref(weight, lambda _, key=key: _packed.pop(key, None)),
            weakref.ref(bias), stamp, w, bf)
    return w, bf


def _forward(x, weight, bias):
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
    path = kernel_path(x.dtype, cin, cout, r)
    w, bf = packed(weight, bias, x.dtype)
    out = torch.empty((b, r, r, r, cout), dtype=x.dtype, device=x.device)
    _lib.launch("bdm_conv3d", x.data_ptr(), w.data_ptr(), bf.data_ptr(),
                out.data_ptr(), b, r, cin, cout, _lib.DTYPE_CODES[x.dtype],
                path=path)
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
