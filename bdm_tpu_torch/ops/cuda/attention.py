"""Voxel self-attention: the `csrc/attention.cu` kernel and its plain
version.

Replaces `_attention_pallas_fwd_only` (bdm_tpu/ops/pallas/attention.py):
softmax(q k^T) v with no 1/sqrt(C) scale, float32 logits and softmax,
weights cast to v's type before the second product.

The source holds two kernels and `kernel_path` says which a call takes, by
type and shape alone: bfloat16 with C a multiple of 8 the tensor-core
kernel ("tc"), float32 and any other C the CUDA-core one ("simt").

`attention` is differentiable (`_attn_vjp_bwd`): the backward recomputes
the float32 logits and softmax and applies the standard cotangents with
`torch.matmul`, rounding where the reference rounds (the weights to v's
type, the logits' cotangent to q's).
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib

MAX_CHANNELS = 128


def kernel_path(dtype: torch.dtype, s: int, c: int) -> str:
    """Which kernel of `csrc/attention.cu` CUDA tensors of this type and
    shape launch (`bdm_attention_path` is the same rule in the source)."""
    tc = dtype == torch.bfloat16 and c % 8 == 0 and c <= MAX_CHANNELS
    return "tc" if tc else "simt"


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, S, C) -> (B, S, C) in v's dtype."""
    _lib.plain_call("attention", q)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(v.dtype)


def _forward(q, k, v):
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check(t, name, (v.dtype,), 3)
    if v.dtype not in _lib.DTYPE_CODES:
        raise TypeError(f"attention: dtype {v.dtype}")
    b, s, c = q.shape
    if k.shape != q.shape or v.shape != q.shape or c > MAX_CHANNELS:
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(C <= {MAX_CHANNELS})")
    path = kernel_path(v.dtype, s, c)
    if path == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: bfloat16 operands must be 16-byte "
                         "aligned")
    out = torch.empty_like(v)
    _lib.launch("bdm_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, s, c, _lib.DTYPE_CODES[v.dtype], path=path)
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        w32 = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)), dim=-1)
        # every (B, S, S) float32 tensor is 537 MB at B=8, S=4096: each is
        # dropped as soon as the next is made
        w = w32.to(v.dtype).float() if v.dtype != torch.float32 else w32
        dv = torch.matmul(w.transpose(1, 2), gf).to(v.dtype)
        del w
        dw = torch.matmul(gf, vf.transpose(1, 2))
        dw -= (dw * w32).sum(dim=-1, keepdim=True)
        dw *= w32
        del w32
        dlogits = dw.to(q.dtype).float() if q.dtype != torch.float32 else dw
        del dw
        dq = torch.matmul(dlogits, kf).to(q.dtype)
        dk = torch.matmul(dlogits.transpose(1, 2), qf).to(k.dtype)
        return dq, dk, dv


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    return _Attention.apply(q, k, v)
