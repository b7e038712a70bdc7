"""PVCNN2, the noise network of PC2 and PVD (`pvcnn.py`, `pvconv.py`,
`pointnet.py`, `shared_mlp.py`, `se.py` of the original), channel-last,
float32, with the original checkpoints' parameter names and shapes.

Every forward takes a `Run`: the precision of the products and, in a
training forward, the dropout keep-masks in the order the dropout sites
run (without them dropout is off).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry as geo
from benchmark.reference.precision import Precision


class Run:
    def __init__(self, precision: Optional[Precision] = None,
                 masks: Optional[Iterator[torch.Tensor]] = None):
        self.p = precision or Precision()
        self.masks = masks

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.masks is None or rate == 0.0:
            return x
        keep = next(self.masks)
        if tuple(keep.shape) != tuple(x.shape):
            raise ValueError(f"keep-mask {tuple(keep.shape)} for a dropout "
                             f"site of shape {tuple(x.shape)}")
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def swish(x):
    return x * torch.sigmoid(x)


class Dense(nn.Module):
    """A 1x1 conv of the original (weight (Cout, Cin, 1, ...)) over the
    last axis."""

    def __init__(self, cin: int, cout: int, kdims: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * kdims))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, run: Run):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(run.p(x), run.p(w), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over the channels of (B, ..., C): statistics over every
    position and the channels of a group, eps 1e-5."""

    def __init__(self, groups: int, c: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x, run: Run = None):
        b, c = x.shape[0], x.shape[-1]
        g = x.reshape(b, -1, self.groups, c // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((g - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
        return y * self.weight + self.bias


class SharedMLP(nn.Module):
    """(1x1 conv -> GroupNorm(8) -> swish) per width; `layers.3j` the
    conv, `layers.3j+1` the norm."""

    def __init__(self, cin: int, widths: Sequence[int], kdims: int):
        super().__init__()
        mods = []
        for w in widths:
            mods += [Dense(cin, w, kdims), GroupNorm(8, w), nn.Identity()]
            cin = w
        self.layers = nn.ModuleList(mods)

    def forward(self, x, run: Run):
        for i in range(0, len(self.layers), 3):
            x = swish(self.layers[i + 1](self.layers[i](x, run)))
        return x


class VoxConv(nn.Module):
    """3x3x3 conv, stride 1, padding 1, on (B, R, R, R, C)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, g, run: Run):
        y = F.conv3d(run.p(g.permute(0, 4, 1, 2, 3)), run.p(self.weight),
                     self.bias, padding=1)
        return y.permute(0, 2, 3, 4, 1)


class Attention(nn.Module):
    """`pvconv.py` Attention: softmax(q k^T) v with no 1/sqrt(C) scale,
    1x1 out, residual, GroupNorm(8), swish."""

    def __init__(self, c: int, kdims: int):
        super().__init__()
        self.q, self.k, self.v, self.out = (Dense(c, c, kdims)
                                            for _ in range(4))
        self.norm = GroupNorm(8, c)

    def forward(self, x, run: Run):
        shape = x.shape
        x = x.reshape(shape[0], -1, shape[-1])
        q, k, v = self.q(x, run), self.k(x, run), self.v(x, run)
        w = torch.softmax(run.p(q) @ run.p(k).transpose(1, 2), dim=-1)
        h = run.p(w) @ run.p(v)
        y = swish(self.norm(x + self.out(h, run)))
        return y.reshape(shape)


class SE(nn.Module):
    """Squeeze-excitation, reduction 8, ReLU, no biases: the (B, C) gate."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // 8, bias=False), nn.ReLU(),
                                nn.Linear(c // 8, c, bias=False),
                                nn.Sigmoid())

    def forward(self, g, run: Run):
        s = g.mean(dim=(1, 2, 3))
        s = F.relu(F.linear(run.p(s), run.p(self.fc[0].weight)))
        return torch.sigmoid(F.linear(run.p(s), run.p(self.fc[2].weight)))


class PVConv(nn.Module):
    """Voxelize -> conv, GN, swish, dropout, conv, GN, attention or swish,
    SE -> devoxelize; plus a one-layer SharedMLP of the points."""

    def __init__(self, cin: int, cout: int, r: int, attention: bool,
                 dropout: float):
        super().__init__()
        self.r = r
        self.dropout = dropout
        self.voxel_layers = nn.ModuleList([
            VoxConv(cin, cout), GroupNorm(8, cout), nn.Identity(),
            nn.Identity(), VoxConv(cout, cout), GroupNorm(8, cout),
            Attention(cout, 3) if attention else nn.Identity(), SE(cout)])
        self.attention = attention
        self.point_features = SharedMLP(cin, (cout,), 1)

    def forward(self, feats, coords, run: Run):
        vl = self.voxel_layers
        nc, ids = geo.voxel_coords(coords, self.r)
        g = geo.avg_voxelize(feats, ids, self.r)
        g = run.dropout(swish(vl[1](vl[0](g, run))), self.dropout)
        g = vl[5](vl[4](g, run))
        g = vl[6](g, run) if self.attention else swish(g)
        gate = vl[7](g, run)
        vox = geo.devoxelize(g, nc) * gate[:, None, :]
        return vox + self.point_features(feats, run)


class PointNetSA(nn.Module):
    """FPS centres, ball-query groups of [relative coords | features],
    SharedMLP, max over the group."""

    def __init__(self, centers: int, radius: float, k: int, cin: int,
                 widths: Sequence[int]):
        super().__init__()
        self.centers, self.radius, self.k = centers, radius, k
        self.mlps = nn.ModuleList([SharedMLP(cin + 3, widths, 2)])

    def forward(self, feats, coords, run: Run):
        b = coords.shape[0]
        idx = geo.furthest_point_sample(coords, self.centers)
        centers = torch.gather(coords, 1, idx[..., None].expand(b, -1, 3))
        nbr = geo.ball_query(centers, coords, self.radius, self.k)
        m, k = nbr.shape[1:]
        flat = nbr.reshape(b, m * k, 1)

        def group(x):
            return torch.gather(x, 1, flat.expand(b, m * k, x.shape[-1])
                                ).reshape(b, m, k, x.shape[-1])

        rel = group(coords) - centers[:, :, None, :]
        f = self.mlps[0](torch.cat([rel, group(feats)], -1), run)
        return f.amax(dim=2), centers


class PointNetFP(nn.Module):
    def __init__(self, cin: int, widths: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(cin, widths, 1)

    def forward(self, fine, coarse, coarse_feats, skip, temb, run: Run):
        f = geo.interpolate(fine, coarse, coarse_feats)
        parts = [f, temb[:, None, :].expand(-1, fine.shape[1], -1)]
        if skip.shape[-1] > 0:
            parts.append(skip)
        return self.mlp(torch.cat(parts, -1), run)


def timestep_embedding(dim: int, t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, dim) [sin | cos], frequencies over half - 1."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float64)
                     * -(math.log(10000.0) / (half - 1))).float()
    e = t.float()[:, None] * freq.to(t.device)[None, :]
    return torch.cat([torch.sin(e), torch.cos(e)], dim=1)


class PVCNN2(nn.Module):
    """`PVCNN2Base` of the original: inputs (B, N, 3 + extra), the first
    three channels the coordinates; t (B,) -> (B, N, out)."""

    def __init__(self, sa_blocks, fp_blocks, extra: int, embed_dim: int = 64,
                 out: int = 3, use_att: bool = True, dropout: float = 0.1):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout = dropout
        in_ch, sa_in, stages = extra + 3, [], []
        for c, (conv, sa) in enumerate(sa_blocks):
            sa_in.append(in_ch)
            mods = []
            if conv is not None:
                cout, blocks, r = conv
                for p in range(blocks):
                    if c == 0 or p == 0:
                        cin = in_ch if c == 0 or p > 0 else in_ch + embed_dim
                        mods.append(PVConv(cin, cout, r,
                                           (c + 1) % 2 == 0 and p == 0
                                           and use_att, dropout))
                    in_ch = cout
                cin = in_ch
            else:
                cin = in_ch + embed_dim
            centers, radius, k, widths = sa
            mods.append(PointNetSA(centers, radius, k, cin, widths))
            in_ch = widths[-1]
            stages.append(nn.ModuleList(mods) if len(mods) > 1 else mods[0])
        sa_in[0] = extra
        self.sa_layers = nn.ModuleList(stages)
        self.global_att = Attention(in_ch, 1) if use_att else None
        fps = []
        for k, (widths, conv) in enumerate(fp_blocks):
            mods = [PointNetFP(in_ch + sa_in[-1 - k] + embed_dim, widths)]
            in_ch = widths[-1]
            if conv is not None:
                cout, blocks, r = conv
                for _ in range(blocks):
                    mods.append(PVConv(in_ch, cout, r, False, dropout))
                    in_ch = cout
            fps.append(nn.ModuleList(mods))
        self.fp_layers = nn.ModuleList(fps)
        self.classifier = nn.ModuleList([SharedMLP(in_ch, (128,), 1),
                                         nn.Identity(), Dense(128, out, 1)])
        self.embedf = nn.Sequential(nn.Linear(embed_dim, embed_dim),
                                    nn.LeakyReLU(0.1),
                                    nn.Linear(embed_dim, embed_dim))

    def forward(self, inputs: torch.Tensor, t: torch.Tensor,
                run: Optional[Run] = None) -> torch.Tensor:
        run = run or Run()
        e = timestep_embedding(self.embed_dim, t)
        temb = F.linear(run.p(e), run.p(self.embedf[0].weight),
                        self.embedf[0].bias)
        temb = F.leaky_relu(temb, 0.1)
        temb = F.linear(run.p(temb), run.p(self.embedf[2].weight),
                        self.embedf[2].bias)
        coords = inputs[..., :3]
        feats = inputs
        coords_list, skips = [], []
        for i, stage in enumerate(self.sa_layers):
            skips.append(feats)
            coords_list.append(coords)
            f = feats if i == 0 else torch.cat(
                [feats, temb[:, None, :].expand(-1, feats.shape[1], -1)], -1)
            mods = list(stage) if isinstance(stage, nn.ModuleList) else [stage]
            for conv in mods[:-1]:
                f = conv(f, coords, run)
            feats, coords = mods[-1](f, coords, run)
        skips[0] = inputs[..., 3:]
        if self.global_att is not None:
            feats = self.global_att(feats, run)
        for k, stage in enumerate(self.fp_layers):
            fine = coords_list[-1 - k]
            feats = stage[0](fine, coords, feats, skips[-1 - k], temb, run)
            coords = fine
            for conv in stage[1:]:
                feats = conv(feats, coords, run)
        f = self.classifier[0](feats, run)
        f = run.dropout(f, self.dropout)
        return self.classifier[2](f, run)
