"""Image features: a timm-compatible ViT in plain PyTorch
(`bdm_tpu/models/feature_model.py`).

Parameter names follow timm's VisionTransformer, so the MSN/MAE weights
load directly. The ViT runs once per trajectory, not once per step; its
attention is plain matmul + softmax (the JAX package has no kernel there).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the released PC2's feature model; other timm names come with the
# configurations that use them
MODEL_KWARGS = {
    "vit_small_patch16_224_msn": dict(patch_size=16, embed_dim=384, depth=12,
                                      num_heads=6),
}


class _Attn(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        w = torch.softmax((q * (d // h) ** -0.5) @ k.transpose(-2, -1), -1)
        return self.proj((w @ v).transpose(1, 2).reshape(b, t, d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _Attn(d, heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, int(d * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, d: int):
        super().__init__()
        self.proj = nn.Conv2d(3, d, patch, stride=patch)


class VisionTransformer(nn.Module):
    """(B, H, W, 3) -> (B, 1 + T, D) tokens, CLS first, after the final
    LayerNorm (timm num_classes=0, global_pool='')."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6):
        super().__init__()
        t = (img_size // patch_size) ** 2 + 1
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, t, embed_dim))
        self.blocks = nn.ModuleList(
            [_Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from `seed` (fan-in uniform, zero biases, unit
        LayerNorms, N(0, 0.02^2) position embedding)."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name == "pos_embed":
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif p.ndim >= 2 and name != "cls_token":
                bound = p[0].numel() ** -0.5
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


class FeatureModel(nn.Module):
    """ImageNet-normalize -> ViT -> drop CLS -> token grid -> bilinear
    upsample to the input size (half-pixel centres, as
    jax.image.resize). `model_name='identity'` returns the image, whatever
    the return type."""

    def __init__(self, image_size: int = 224,
                 model_name: str = "vit_small_patch16_224_msn",
                 vit_kwargs: dict | None = None):
        super().__init__()
        self.image_size = image_size
        self.model_name = model_name
        if model_name == "identity":
            self.feature_dim = 3
            return
        kw = vit_kwargs or MODEL_KWARGS[model_name]
        self.feature_dim = kw["embed_dim"]
        self.model = VisionTransformer(img_size=image_size, **kw)

    def forward(self, images: torch.Tensor, return_type: str = "features"):
        """images (B, H, W, 3) in [0, 1] -> "features": (B, H, W, D)
        float32; "cls_token": the CLS token (B, D); "all": (CLS token,
        features) from one ViT forward."""
        if self.model_name == "identity":
            return images
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        tokens = self.model((images - mean) / std)
        if return_type == "cls_token":
            return tokens[:, 0]
        b, t, d = tokens.shape
        g = int(round((t - 1) ** 0.5))
        grid = tokens[:, 1:].reshape(b, g, g, d).permute(0, 3, 1, 2)
        up = F.interpolate(grid, size=(self.image_size, self.image_size),
                           mode="bilinear", align_corners=False)
        feats = up.permute(0, 2, 3, 1)
        return (tokens[:, 0], feats) if return_type == "all" else feats
