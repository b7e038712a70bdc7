"""Trilinear devoxelization with the squeeze-excitation gate and the point
branch's residual: the `csrc/devox.cu` kernel and its plain version.

Replaces no TPU kernel: `bdm_tpu/ops/voxelize.py::trilinear_devoxelize` is
jnp, which XLA fuses with what follows it on the TPU. One call is a PVConv's
output after its voxel layers:

    out = dt(dt(dt(devox) * dt(gate)) + dt(pf)),

devox the float32 trilinear sample of the (B, R, R, R, C) grid at the
(B, N, 3) voxel coordinates (`trilinear_devoxelize`: the upper corner along
an axis only where its fraction is > 0, the corners summed in float32 in a
fixed order), gate (B, C) float32, pf (B, N, C) and dt() one rounding to
the grid's type. The kernel rounds every product and sum on its own in
the plain version's order: it gives the plain version's bits.

`gated_devoxelize` sends a CPU tensor to the plain version and launches
the kernel for a CUDA tensor (or raises). Under autograd it goes through
`_GatedDevox`, whose backward is PyTorch operations and
`ops.cuda.scatter_sum` (deterministic, no atomics): each corner's
w * g row is summed into its voxel, S (B, R^3, C) float32; then
d grid = S * dt(gate) cast to the grid's type, d gate = sum over voxels of
grid * S (the sum over points of g * devox, grouped by voxel: the
unrounded devox, so no (B, N, C) tensor is kept), d pf = g. The
coordinates carry no gradient.

A thread of the kernel takes 16 bytes of channels of one point (8 bf16 or
4 float32); a C that is no multiple of that is refused.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.ops.cuda import scatter_sum as _ss


def corners(norm_coords: torch.Tensor, resolution: int):
    """(B, N, 3) float32 in [0, R-1] -> the 8 corners' flat voxel ids
    (B, N, 8) int64 and weights (B, N, 8) float32, dx outer, dy, dz inner.
    The upper corner along an axis is used only when its fractional part
    is > 0 (`trilinear_devox.cu` corner rule); a weight is (wx * wy) * wz."""
    r = resolution
    lo_f = torch.floor(norm_coords)
    frac = norm_coords - lo_f
    lo = lo_f.long()
    step = (frac > 0).long()
    strides = (r * r, r, 1)
    base = lo[..., 0] * strides[0] + lo[..., 1] * strides[1] + lo[..., 2]
    ids, ws = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ids.append(base + dx * step[..., 0] * strides[0]
                           + dy * step[..., 1] * strides[1]
                           + dz * step[..., 2] * strides[2])
                ws.append((frac[..., 0] if dx else 1.0 - frac[..., 0])
                          * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                          * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
    return torch.stack(ids, -1), torch.stack(ws, -1)


def trilinear_devoxelize(grid: torch.Tensor,
                         norm_coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, R, R, R, C) at float coords in [0, R-1] -> (B, N, C)
    float32: the 8 corners of `corners`, each gathered and added in turn to
    a float32 sum that starts from zero."""
    b, r = grid.shape[:2]
    c = grid.shape[-1]
    n = norm_coords.shape[1]
    ids, ws = corners(norm_coords, r)
    flat = grid.reshape(b, r ** 3, c)
    out = torch.zeros((b, n, c), dtype=torch.float32, device=grid.device)
    for k in range(8):
        vals = torch.gather(flat, 1, ids[..., k, None].expand(b, n, c))
        out = out + ws[..., k, None] * vals.float()
    return out


def gated_devoxelize_plain(grid: torch.Tensor, norm_coords: torch.Tensor,
                           gate: torch.Tensor,
                           pf: torch.Tensor) -> torch.Tensor:
    """grid (B, R, R, R, C), norm_coords (B, N, 3) float32, gate (B, C)
    float32, pf (B, N, C) -> (B, N, C) in the grid's type."""
    _lib.plain_call("devox", grid)
    dt = grid.dtype
    vox = trilinear_devoxelize(grid, norm_coords).to(dt)
    return vox * gate[:, None, :].to(dt) + pf.to(dt)


def _check(grid, norm_coords, gate, pf):
    """-> (B, N, R, C), or raises where the kernel does not take the call."""
    _lib.check(grid, "grid", tuple(_lib.DTYPE_CODES), 5)
    _lib.check(norm_coords, "norm_coords", (torch.float32,), 3)
    _lib.check(gate, "gate", (torch.float32,), 2)
    _lib.check(pf, "pf", (grid.dtype,), 3)
    b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
    n = norm_coords.shape[1]
    if (grid.shape[1:4] != (r, r, r) or norm_coords.shape != (b, n, 3)
            or gate.shape != (b, c) or pf.shape != (b, n, c)):
        raise ValueError(f"gated_devoxelize: grid {tuple(grid.shape)}, "
                         f"norm_coords {tuple(norm_coords.shape)}, gate "
                         f"{tuple(gate.shape)}, pf {tuple(pf.shape)}")
    if c * grid.element_size() % 16:
        raise ValueError(f"gated_devoxelize: C {c} of {grid.dtype} is no "
                         f"multiple of 16 bytes")
    if b > 65535 or n * c >= 2 ** 31 or r ** 3 * c >= 2 ** 31:
        raise ValueError(f"gated_devoxelize: B {b}, N {n}, R {r}, C {c} "
                         f"past the kernel's 32-bit offsets")
    if any(t.data_ptr() % 16 for t in (grid, gate, pf)):
        raise ValueError("gated_devoxelize: grid, gate and pf must be "
                         "16-byte aligned")
    return b, n, r, c


def _forward(grid, norm_coords, gate, pf):
    pf = pf.to(grid.dtype)
    b, n, r, c = _check(grid, norm_coords, gate, pf)
    out = torch.empty_like(pf)
    _lib.launch("bdm_devox", grid.data_ptr(), norm_coords.data_ptr(),
                gate.data_ptr(), pf.data_ptr(), out.data_ptr(), b, n, r, c,
                _lib.DTYPE_CODES[grid.dtype])
    return out


class _GatedDevox(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, norm_coords, gate, pf):
        ctx.save_for_backward(grid, norm_coords, gate)
        ctx.pf_dtype = pf.dtype
        if grid.device.type == "cpu":
            return gated_devoxelize_plain(grid, norm_coords, gate, pf)
        return _forward(grid, norm_coords, gate, pf)

    @staticmethod
    def backward(ctx, g):
        grid, norm_coords, gate = ctx.saved_tensors
        b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
        n = norm_coords.shape[1]
        need = ctx.needs_input_grad
        dgrid = dgate = None
        if need[0] or need[2]:
            ids, ws = corners(norm_coords, r)
            rows = (ws[..., None] * g.float()[:, :, None, :]).reshape(
                b, 8 * n, c)
            s = _ss.scatter_sum(rows, ids.reshape(b, 8 * n).to(
                torch.int32).contiguous(), r ** 3)
            if need[0]:
                gq = gate.to(grid.dtype).float()
                dgrid = (s * gq[:, None, :]).reshape(grid.shape).to(
                    grid.dtype)
            if need[2]:
                dgate = (grid.float().reshape(b, r ** 3, c) * s).sum(1)
        dpf = g.to(ctx.pf_dtype) if need[3] else None
        return dgrid, None, dgate, dpf


def gated_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                     gate: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones: grid
    (B, R, R, R, C) bf16 or float32, norm_coords (B, N, 3) float32 in
    [0, R-1], gate (B, C) float32, pf (B, N, C) (rounded to the grid's
    type) -> (B, N, C) in the grid's type; on the card C is a multiple of
    16 bytes. Differentiable in grid, gate and pf."""
    if grid.device.type == "cpu":
        return gated_devoxelize_plain(grid, norm_coords, gate, pf)
    if torch.is_grad_enabled() and (grid.requires_grad or gate.requires_grad
                                    or pf.requires_grad):
        return _GatedDevox.apply(grid, norm_coords, gate, pf)
    return _forward(grid, norm_coords, gate, pf)
