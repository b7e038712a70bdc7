"""Three-neighbour blend of bf16 features: the `csrc/interp.cu` kernel and
its plain version.

Replaces `_interp_mm_fwd_pallas` / `interp_mm`
(bdm_tpu/ops/pallas/interp_mm.py): out[n] = sum_k bf16(w_k[n]) *
F[idx_k[n]], float32 accumulation in k order, one rounding to bf16. The
TPU kernel's one-hot matrix sums the weights of equal indices before the
rounding; `three_nn` returns three distinct indices for M >= 3, where the
two forms agree up to the order of the float32 sum. The kernel gives the
plain version's bits.

`interp_mm` is differentiable in the features (`_interp_mm_bwd`): the 3N
cotangent rows, each times its float32 weight (not the bf16-rounded one),
are summed into the centres they were read from by `ops.cuda.scatter_sum`,
and the sum is cast to the features' dtype. Indices and weights come from
coordinates that carry no gradient.

A thread of the kernel takes one group of `vec` channels (8, or 1 where C
is no multiple of 8: "scalar") of ROWS rows; the kernels' ledger counts
the launches of each.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.ops.cuda import scatter_sum as _ss

# the source's split (`bdm_interp_threads`, `bdm_interp_rows`): a block of
# THREADS threads, ROWS rows a thread
THREADS = 128
ROWS = 2


def _check_shapes(idx, w, feats) -> None:
    if feats.dtype != torch.bfloat16:
        raise TypeError(f"interp_mm: features must be bfloat16, got "
                        f"{feats.dtype} (float32 takes the gather form)")
    if (idx.dim() != 3 or idx.shape[-1] != 3 or w.shape != idx.shape
            or feats.dim() != 3 or feats.shape[0] != idx.shape[0]
            or feats.shape[1] < 1):
        raise ValueError(f"interp_mm: idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}, feats {tuple(feats.shape)}")


def interp_mm_plain(idx: torch.Tensor, w: torch.Tensor,
                    feats: torch.Tensor) -> torch.Tensor:
    """idx (B, N, 3) int32, w (B, N, 3) float32, feats (B, M, C) bf16
    -> (B, N, C) bf16."""
    _check_shapes(idx, w, feats)
    _lib.plain_call("interp_mm", feats)
    b, n, _ = idx.shape
    c = feats.shape[-1]
    wb = w.to(torch.bfloat16).float()
    # float32 before the gather: the same values, and autograd then sums
    # a centre's cotangent rows in float32, not in bf16
    g = torch.gather(feats.float(), 1, idx.reshape(b, n * 3, 1).long()
                     .expand(b, n * 3, c)).reshape(b, n, 3, c)
    out = (g[:, :, 0] * wb[..., 0:1] + g[:, :, 1] * wb[..., 1:2]) \
        + g[:, :, 2] * wb[..., 2:3]
    return out.to(feats.dtype)


def _forward(idx, w, feats):
    if feats.device.type == "cpu":
        return interp_mm_plain(idx, w, feats)
    _lib.check(idx, "idx", (torch.int32,), 3)
    _lib.check(w, "w", (torch.float32,), 3)
    _lib.check(feats, "feats", (torch.bfloat16,), 3)
    _check_shapes(idx, w, feats)
    b, n, _ = idx.shape
    m, c = feats.shape[1:]
    if b * n * max(c, 3) >= 2 ** 31 or b * m * c >= 2 ** 31 or b > 65535:
        raise ValueError(f"interp_mm: B {b}, N {n}, M {m}, C {c} past the "
                         f"kernel's 32-bit offsets")
    out = torch.empty((b, n, c), dtype=feats.dtype, device=feats.device)
    if c % 8 == 0 and (feats.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("interp_mm: features must be 16-byte aligned")
    _lib.launch("bdm_interp", idx.data_ptr(), w.data_ptr(), feats.data_ptr(),
                out.data_ptr(), b, n, m, c, path="scalar" if c % 8 else "vec")
    return out


class _InterpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, w, feats):
        ctx.save_for_backward(idx, w)
        ctx.m, ctx.in_dtype = feats.shape[1], feats.dtype
        return _forward(idx, w, feats)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        b, n, _ = idx.shape
        rows = (g.float()[:, :, None, :] * w[..., None]).reshape(
            b, n * 3, g.shape[-1])
        df = _ss.scatter_sum(rows, idx.reshape(b, n * 3).contiguous(), ctx.m)
        return None, None, df.to(ctx.in_dtype)


def interp_mm(idx: torch.Tensor, w: torch.Tensor,
              feats: torch.Tensor) -> torch.Tensor:
    return _InterpMM.apply(idx, w, feats)
