"""PC2 and PVD around the reference PVCNN2, with the original checkpoints'
key layout (`point_cloud_model.model.*`, `feature_model.model.*`;
PVD's `model.*`), and the image features of PC2: a timm ViT-S/16 (MSN's
widths), ImageNet normalisation, the CLS token dropped, the 14 x 14 token
grid upsampled bilinearly (half-pixel centres) to the image size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry as geo
from benchmark.reference.pvcnn import PVCNN2, Run

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _Holder(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class _Attn(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class _Block(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _Attn(d, heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, 4 * d)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, d: int):
        super().__init__()
        self.proj = nn.Conv2d(3, d, patch, stride=patch)


def _linear(x, layer: nn.Linear, run: Run):
    return F.linear(run.p(x), run.p(layer.weight), layer.bias)


class ViT(nn.Module):
    """timm's VisionTransformer, no head: (B, H, W, 3) -> (B, 1 + T, D)
    after the final LayerNorm."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 depth: int, num_heads: int):
        super().__init__()
        t = (img_size // patch_size) ** 2 + 1
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, t, embed_dim))
        self.blocks = nn.ModuleList(_Block(embed_dim, num_heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, images, run: Run):
        b = images.shape[0]
        pe = self.patch_embed.proj
        x = F.conv2d(run.p(images.permute(0, 3, 1, 2)), run.p(pe.weight),
                     pe.bias, stride=pe.stride)
        x = torch.cat([self.cls_token.expand(b, -1, -1),
                       x.flatten(2).transpose(1, 2)], 1) + self.pos_embed
        for blk in self.blocks:
            h = blk.norm1(x)
            n, t, d = h.shape
            heads = blk.attn.heads
            qkv = _linear(h, blk.attn.qkv, run).reshape(
                n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            w = torch.softmax(run.p(q * (d // heads) ** -0.5)
                              @ run.p(k).transpose(-2, -1), -1)
            a = (run.p(w) @ run.p(v)).transpose(1, 2).reshape(n, t, d)
            x = x + _linear(a, blk.attn.proj, run)
            h = F.gelu(_linear(blk.norm2(x), blk.mlp.fc1, run))
            x = x + _linear(h, blk.mlp.fc2, run)
        return self.norm(x)


class PC2(nn.Module):
    """The projection-conditioned noise network: the conditioning map
    [(image - 0.5) / 0.5 | ViT features] per pixel, projected onto the
    points each step, [x_t | projection] into PVCNN2."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        vit = cfg["vit"]
        self.feature_model = _Holder(ViT(cfg["image_size"], **vit))
        extra = 3 + vit["embed_dim"]
        self.point_cloud_model = _Holder(PVCNN2(
            cfg["sa_blocks"], cfg["fp_blocks"], extra, cfg["embed_dim"], 3,
            True, cfg["dropout"]))

    @torch.no_grad()
    def conditioning(self, image: torch.Tensor,
                     run: Optional[Run] = None) -> torch.Tensor:
        """(B, S, S, 3) in [0, 1] -> (B, S*S, 3 + D) float32."""
        run = run or Run()
        s = image.shape[1]
        mean = image.new_tensor(IMAGENET_MEAN)
        std = image.new_tensor(IMAGENET_STD)
        tokens = self.feature_model.model((image - mean) / std, run)
        b, t, d = tokens.shape
        g = int(round((t - 1) ** 0.5))
        grid = tokens[:, 1:].reshape(b, g, g, d).permute(0, 3, 1, 2)
        feats = F.interpolate(grid, size=(s, s), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        colors = (image - 0.5) / 0.5
        return torch.cat([colors, feats], -1).reshape(b, s * s, -1)

    def inputs(self, x_t, cam: dict, cond: torch.Tensor) -> torch.Tensor:
        proj = geo.surface_projection(x_t, cam, cond,
                                      self.cfg["raster_point_radius"])
        return torch.cat([x_t, proj], -1)

    def denoise(self, x_t, t, cam: dict, cond, run: Optional[Run] = None):
        return self.point_cloud_model.model(self.inputs(x_t, cam, cond), t,
                                            run)


class PVD(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.model = PVCNN2(cfg["sa_blocks"], cfg["fp_blocks"], 0,
                            cfg["embed_dim"], 3, cfg["use_att"],
                            cfg["dropout"])

    def denoise(self, x_t, t, run: Optional[Run] = None):
        return self.model(x_t, t, run)
