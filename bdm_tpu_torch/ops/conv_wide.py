"""The 27-tap shift-sum of the precontracted stage-0 conv
(`bdm_tpu/ops/conv_wide.py::tap_shift_sum`).

A SAME 3x3x3 conv is out[v] = sum_t shift_t(x)[v] @ W_t = sum_t
shift_t(x @ W_t)[v]: with the per-tap products taken per point before the
scatter-mean (the precontracted conditioning), only the shifted sum of
27 Cout-wide slices is left per step. The JAX package computes it in plain
jnp outside any Pallas kernel; so does this, in place over an unpadded
float32 accumulator (the zero padding of the JAX form adds exact zeros).
"""

from __future__ import annotations

import torch


def _span(o: int, r: int):
    """Output and input slices of a shift by o in {-1, 0, 1} over r."""
    return slice(max(0, -o), r - max(0, o)), slice(max(0, o), r + min(0, o))


def tap_shift_sum(g: torch.Tensor, cout: int) -> torch.Tensor:
    """g (B, R, R, R, 27 * Cout), tap-major blocks in (kd, kh, kw) order
    -> (B, R, R, R, Cout) float32: out[v] = sum_t g[v + delta(t),
    block t], the taps summed in t order, zero outside the grid."""
    b, r = g.shape[0], g.shape[1]
    out = torch.zeros((b, r, r, r, cout), dtype=torch.float32,
                      device=g.device)
    t = 0
    for dz in (-1, 0, 1):
        oz, iz = _span(dz, r)
        for dy in (-1, 0, 1):
            oy, iy = _span(dy, r)
            for dx in (-1, 0, 1):
                ox, ix = _span(dx, r)
                out[:, oz, oy, ox] += g[:, iz, iy, ix,
                                        t * cout:(t + 1) * cout]
                t += 1
    return out
