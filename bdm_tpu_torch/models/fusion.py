"""PVCNNFuse, the BDM-Merging fusion network (`bdm_tpu/models/fusion.py`,
reference `pvcnn_fuse.py:14-277`).

Two PVCNN2 encoder towers (PC2's over the conditioned input, PVD's over
bare coordinates) are fused per scale into a copy of the PC2 decoder
through zero-initialised projections, so at initialisation the network is
exactly the PC2 backbone.

Modes: "fusion_nstep" feeds the PVD tower the prior branch's cloud,
"fusion_1step" the recon coordinates.

As in `bdm_tpu` (and unlike the reference, whose indexing there is out of
bounds), the PVD tower gets the full-resolution timestep embedding and the
decoder the one the PC2 tower returns.

The forward replays a captured CUDA graph under `models.graphs`'s rule, as
PVCNN2's does; the mode is part of the graph's key.

State-dict keys are the reference fusion checkpoint's: `embedf`,
`pc2_model_sa_layers`, `pc2_model_global_att`, `pvd_model_sa_layers`,
`pvd_model_global_att`, `fusion_decoder_fp_layers`, `classifier`,
`projs.{i}.{0,2,3}` (one projection per skip scale, the bottleneck's last).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from bdm_tpu_torch.models.graphs import Graphed
from bdm_tpu_torch.models.layers import (Conv1x1, get_timestep_embedding,
                                         timestep_mlp)
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNNDecoder, PVCNNEncoder,
                                        build_pvcnn2_specs, init_uniform)
from bdm_tpu_torch.utils.spans import span

MODES = ("fusion_nstep", "fusion_1step")


class ZeroConvProj(nn.Sequential):
    """Per-scale projection (`pvcnn_fuse.py:111-123`): Conv1d ->
    LeakyReLU(0.02) -> Conv1d -> zero-conv, in float32 on (B, N, dim)."""

    def __init__(self, dim: int):
        super().__init__(Conv1x1(dim, dim, 1), nn.LeakyReLU(0.02),
                         Conv1x1(dim, dim, 1), Conv1x1(dim, dim, 1))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 2/dim) weights and zero biases; the zero-conv all zero."""
        dim = self[0].weight.shape[0]
        for conv in (self[0], self[2]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * float(np.sqrt(2.0 / dim)))
            conv.bias.zero_()
        self[3].weight.zero_()
        self[3].bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class PVCNNFuse(Graphed):
    """forward(recon input (B, N, 3 + S), prior cloud (B, N, 3), t (B,),
    mode) -> (B, N, out_channels) float32. Leaves its constructor in
    `eval()` mode."""

    def __init__(self, out_channels: int = 3, embed_dim: int = 64,
                 extra_feature_channels: int = 3, use_att: bool = True,
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        mult = (width_multiplier, voxel_resolution_multiplier)
        self.pc2_specs = build_pvcnn2_specs(
            sa_blocks, fp_blocks, extra_feature_channels, use_att, *mult)
        self.pvd_specs = build_pvcnn2_specs(sa_blocks, fp_blocks, 0, use_att,
                                            *mult)
        self.embedf = timestep_mlp(embed_dim)
        self.pc2_encoder = PVCNNEncoder(self.pc2_specs, embed_dim, use_att,
                                        dtype, dropout)
        self.pc2_model_sa_layers = self.pc2_encoder.sa_layers
        self.pvd_encoder = PVCNNEncoder(self.pvd_specs, embed_dim, use_att,
                                        dtype, dropout)
        self.pvd_model_sa_layers = self.pvd_encoder.sa_layers
        if use_att:
            self.pc2_model_global_att = self.pc2_encoder.global_att
            self.pvd_model_global_att = self.pvd_encoder.global_att
        self.decoder = PVCNNDecoder(self.pc2_specs, embed_dim, out_channels,
                                    dtype, dropout)
        self.fusion_decoder_fp_layers = self.decoder.fp_layers
        self.classifier = self.decoder.classifier
        # the skip scales of the PVD tower, then its bottleneck
        dims = list(self.pvd_specs.sa_in_channels[1:]) + [
            self.pvd_specs.channels_sa_features]
        self.projs = nn.ModuleList([ZeroConvProj(d) for d in dims])
        self.eval()   # as PVCNN2: dropout off outside a training step

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from `seed`; the projections as the reference
        initialises them (zero-convs at zero)."""
        g = torch.Generator().manual_seed(seed)
        init_uniform(self, g)
        for proj in self.projs:
            proj.reset_parameters(g)

    def forward(self, recon_inputs_with_cond: torch.Tensor,
                input_from_prior: torch.Tensor, t: torch.Tensor,
                mode: str = "fusion_nstep") -> torch.Tensor:
        """Replays a captured CUDA graph of the mode where `models.graphs`'s
        rule allows it (on the card, autograd off, `eval()`, spans off, no
        hook inside), else runs eagerly."""
        if mode not in MODES:
            raise ValueError(f"PVCNNFuse: mode {mode!r} not in {MODES}")
        with span("network"):
            return self.graphs(self, lambda *a: self._forward(*a, mode),
                               recon_inputs_with_cond, input_from_prior, t,
                               key=mode)

    def _forward(self, x, input_from_prior, t, mode) -> torch.Tensor:
        temb = self.embedf(get_timestep_embedding(self.embed_dim, t))
        coords_pc2 = x[..., :3].float()
        f_pc2, cc_pc2, temb_pc2, coords_list, pc2_skips = \
            self.pc2_encoder(x, coords_pc2, temb)
        pc2_skips[0] = x[..., 3:]
        with span("fusion.pvd_tower"):
            coords_pvd = (input_from_prior[..., :3].float()
                          if mode == "fusion_nstep" else coords_pc2)
            f_pvd, _, _, _, pvd_skips = self.pvd_encoder(
                coords_pvd, coords_pvd, temb)
        with span("fusion.project"):
            fused = self.projs[-1](f_pvd) + f_pc2
            fused_skips = [pc2_skips[0]] + [
                proj(pvd_s) + pc2_s for proj, pvd_s, pc2_s
                in zip(self.projs, pvd_skips[1:], pc2_skips[1:])]
        return self.decoder(fused, cc_pc2, temb_pc2, coords_list,
                            fused_skips)
