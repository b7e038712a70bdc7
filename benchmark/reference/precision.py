"""The precision of the reference's products.

`Precision("float32")` is the reference: operands as they are, TF32 off.
A lower one rounds both operands of every matrix product, convolution and
attention product before it, and computes the product itself in float32;
in a backward pass the gradient reaching an operand is rounded too.
"bfloat16" rounds both ways to bfloat16; "fp8" rounds operands to float8
e4m3 and gradients to float8 e5m2 (the usual pair for fp8 training), each
under one scale a tensor that takes its largest magnitude to the type's
largest finite value. The control of the benchmark's comparison is the
reference at "fp8", the precision next below the bfloat16 that the
configurations state.
"""

from __future__ import annotations

import torch

KINDS = ("float32", "bfloat16", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 `dtype` under one scale that takes its
    largest magnitude to `top`."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """Round the operand going forward and its gradient going back."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        if kind == "bfloat16":
            return x.to(torch.bfloat16).float()
        return _scaled(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.kind == "bfloat16":
            return g.to(torch.bfloat16).float(), None
        return _scaled(g, torch.float8_e5m2, E5M2_MAX), None


class Precision:
    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision {kind!r}: one of {KINDS}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """One operand of a product, rounded to this precision, as
        float32."""
        x = x.float()
        return x if self.kind == "float32" else _Round.apply(x, self.kind)


class no_tf32:
    """Float32 products at float32 inside the block: TF32 off for cuBLAS
    and cuDNN, restored on exit."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False
