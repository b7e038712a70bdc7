"""GroupNorm over the last axis of channel-last (B, ..., C) tensors, with
an optional SiLU: the `csrc/groupnorm.cu` kernel pair and its plain
version.

Replaces no TPU kernel: `bdm_tpu/models/layers.py`'s GroupNorm is flax's
`nn.GroupNorm` in jnp, not Pallas (XLA fuses it on the TPU). The plain
version is `models.layers.GroupNormCL`'s math followed by `F.silu`:
float32 statistics over every non-batch position and the channels of a
group, the mean and then the mean of squared deviations, the affine in
float32 and one cast to the output type, then SiLU in that type. The
kernel computes the statistics in another order (per chunk of rows, merged
by Chan's formula) and applies SiLU to the float32 affine before its one
rounding: float32 results agree to the last bits of the statistics, bf16
ones to a rounding of the affine.

`group_norm` sends a CPU tensor to the plain version and launches the
kernel pair for a CUDA tensor (or raises), whether or not a gradient is
wanted and whether or not x is a point shard:
  * with `group`, x is this rank's shard of the point axis (split evenly):
    the statistics kernel runs on the shard, one `all_gather` brings every
    rank's (n, mean, M2) partials, and the apply kernel merges them all in
    one fixed order, so every rank normalises with the whole's statistics;
  * under autograd (`_GroupNorm`) the apply kernel also writes the
    statistics it used, and the backward recomputes the normalised input
    from them in float32 and applies GroupNorm's and SiLU's cotangents
    with PyTorch operations, as the other wrappers' backwards do; with
    `group` the two sums of the input's cotangent take one SUM over the
    ranks, and the weight's and bias's cotangents are this rank's part.

A call without `group` is one launch of `bdm_groupnorm`, which the
kernels' ledger counts as the pair's two launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bdm_tpu_torch.ops.cuda import _lib

# the source's split (`bdm_groupnorm_chunks`): a block of THREADS threads,
# VECS 16-byte vectors a thread, at most MAX_GROUPS groups
THREADS = 256
VECS = 16
MAX_GROUPS = 32
_LANES = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes


def chunks(s: int, c: int, groups: int, dtype: torch.dtype) -> int:
    """The chunks of rows a sample of (S, C) is split into, or 0 where the
    kernels do not take the shape (`bdm_groupnorm_chunks`)."""
    w = _LANES.get(dtype)
    if w is None:
        return 0
    if (s < 1 or c < 1 or not 1 <= groups <= MAX_GROUPS or c % groups
            or c % w or c // w > THREADS or s * c >= 2 ** 31):
        return 0
    rows = THREADS // (c // w) * VECS
    return -(-s // rows)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     dtype=None, silu: bool = False,
                     group=None) -> torch.Tensor:
    """x (B, ..., C), weight and bias (C,) float32 -> (B, ..., C) in
    `dtype` (default x's). With `group`, x is a shard of the point axis
    and the statistics are the whole's (`parallel.sharded_mean`)."""
    _lib.plain_call("groupnorm", x)
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    if group is None:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        # imported here: `point_sharded` imports `ops`, which imports this
        from bdm_tpu_torch.parallel.point_sharded import sharded_mean
        mean = sharded_mean(xf, group)
        var = sharded_mean((xf - mean).square(), group)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (y * weight + bias).to(dtype or x.dtype)
    return F.silu(y) if silu else y


def _check(x, weight, bias, groups):
    """-> (B, S, C, chunks), or raises where the kernels do not take the
    call."""
    if x.dim() < 2:
        raise ValueError(f"group_norm: x {tuple(x.shape)} has no channel "
                         f"axis")
    _lib.check(x, "x", tuple(_lib.DTYPE_CODES), x.dim())
    b, c = x.shape[0], x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        _lib.check(t, name, (torch.float32,), 1)
        if t.shape[0] != c:
            raise ValueError(f"group_norm: {name} {tuple(t.shape)} for C {c}")
    s = x.numel() // max(b * c, 1)
    n = chunks(s, c, groups, x.dtype)
    if n == 0 or b > 65535:
        raise ValueError(f"group_norm: B {b}, S {s}, C {c}, G {groups} "
                         f"{x.dtype}: not a shape the kernels take")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")
    return b, s, c, n


def _forward(x, weight, bias, groups, eps, silu, group, keep_stats):
    """The kernel pair -> (out in x's dtype, the (B, G, 2) float32 (mean,
    rstd) where `keep_stats`, else None)."""
    b, s, c, n = _check(x, weight, bias, groups)
    out = torch.empty_like(x)
    part = torch.empty((b, n, groups, 4), dtype=torch.float32,
                       device=x.device)
    stats = (torch.empty((b, groups, 2), dtype=torch.float32,
                         device=x.device) if keep_stats else None)
    st = 0 if stats is None else stats.data_ptr()
    code = _lib.DTYPE_CODES[x.dtype]
    if group is None:
        _lib.launch("bdm_groupnorm", x.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), part.data_ptr(), st, b,
                    s, c, groups, eps, int(silu), code)
    else:
        _lib.launch("bdm_groupnorm_stats", x.data_ptr(), part.data_ptr(), b,
                    s, c, groups, code)
        ranks = dist.get_world_size(group)
        every = part.new_empty((ranks,) + tuple(part.shape))
        dist.all_gather(list(every.unbind(0)), part, group=group)
        _lib.launch("bdm_groupnorm_apply", x.data_ptr(), every.data_ptr(),
                    ranks, weight.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), st, b, s, c, groups, eps, int(silu),
                    code)
    return out, stats


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu, group):
        out, stats = _forward(x, weight, bias, groups, eps, silu, group,
                              True)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.groups, ctx.silu, ctx.group = groups, silu, group
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, stats = ctx.saved_tensors
        b, c = x.shape[0], x.shape[-1]
        shape = (b, -1, ctx.groups, c // ctx.groups)
        mean = stats[..., 0].reshape(b, 1, ctx.groups, 1)
        rstd = stats[..., 1].reshape(b, 1, ctx.groups, 1)
        xhat = (x.float().reshape(shape) - mean) * rstd
        w = weight.reshape(ctx.groups, -1)
        dy = g.float().reshape(shape)
        if ctx.silu:
            y = xhat * w + bias.reshape(ctx.groups, -1)
            sig = torch.sigmoid(y)
            dy = dy * (sig * (1 + y * (1 - sig)))
        dw = (dy * xhat).sum(dim=(0, 1)).reshape(c)
        db = dy.sum(dim=(0, 1)).reshape(c)
        dxhat = dy * w
        # the means over the group of dxhat and dxhat * xhat
        sums = torch.stack([dxhat.sum(dim=(1, 3)),
                            (dxhat * xhat).sum(dim=(1, 3))])
        count = xhat.shape[1] * xhat.shape[3]
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
            count *= dist.get_world_size(ctx.group)
        m1, m2 = (sums / count).reshape(2, b, 1, ctx.groups, 1)
        dx = (dxhat - m1 - xhat * m2) * rstd
        need = ctx.needs_input_grad
        return (dx.reshape(x.shape).to(x.dtype) if need[0] else None,
                dw if need[1] else None, db if need[2] else None,
                None, None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, dtype=None, silu: bool = False,
               group=None) -> torch.Tensor:
    """The kernel pair on a CUDA tensor, the plain form on a CPU one:
    x (B, ..., C) bf16 or float32, contiguous and 16-byte aligned, weight
    and bias (C,) float32 -> (B, ..., C) in `dtype`, which on the card must
    be x's (the kernels change no type). With `group`, x is this rank's
    shard of a (B, N, ...) tensor whose point axis is split evenly over
    the ranks of that process group, and the statistics are the whole's.
    Differentiable in x, weight and bias."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, dtype, silu,
                                group)
    if dtype not in (None, x.dtype):
        raise TypeError(f"group_norm: {x.dtype} -> {dtype}: the kernels "
                        f"keep x's type")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, groups, eps, silu, group)
    return _forward(x, weight, bias, groups, eps, silu, group, False)[0]
