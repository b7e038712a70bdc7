"""BDM-Merging's fusion network `PVCNN_fuse` (`pvcnn_fuse.py:14-277` of the
original) and its sampling step (`model.py:510-570`), channel-last,
float32, built from the modules of `pvcnn.py` under the fusion
checkpoint's keys: `embedf`, `pc2_model_sa_layers`, `pc2_model_global_att`,
`pvd_model_sa_layers`, `pvd_model_global_att`, `fusion_decoder_fp_layers`,
`classifier` and `projs.{i}.{0,2,3}`.

Two PVCNN2 encoder towers run side by side: PC2's over the conditioned
input [x_t | projection], PVD's over a bare cloud (the prior branch's in
"fusion_nstep", the recon coordinates in "fusion_1step"). At each skip
scale and at the bottleneck the PVD tower's features pass through Conv1d ->
LeakyReLU(0.02) -> Conv1d -> zero-conv and are added to PC2's, and the PC2
decoder runs on the sums.

Departures from the original, besides those of the package (`__init__`):
  * the PVD tower takes the full-resolution timestep embedding, as the
    decoder does: the original indexes out of bounds there;
  * the projections' products pass through the run's `Precision` like every
    other product (the original runs them in float32, which the reference
    is anyway).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.pvcnn import PVCNN2, Dense, Run, timestep_embedding

MODES = ("fusion_nstep", "fusion_1step")


def projection(dim: int) -> nn.Sequential:
    """Conv1d -> LeakyReLU(0.02) -> Conv1d -> zero-conv: keys 0, 2, 3."""
    return nn.Sequential(Dense(dim, dim, 1), nn.LeakyReLU(0.02),
                         Dense(dim, dim, 1), Dense(dim, dim, 1))


def _project(proj: nn.Sequential, x: torch.Tensor, run: Run) -> torch.Tensor:
    h = F.leaky_relu(proj[0](x, run), 0.02)
    return proj[3](proj[2](h, run), run)


def _encode(sa_layers, global_att, inputs, temb, run: Run):
    """The SA tower of `PVCNN2.forward` -> (bottleneck features, its
    coordinates, the coordinates and input features of every stage)."""
    coords, feats = inputs[..., :3], inputs
    coords_list, skips = [], []
    for i, stage in enumerate(sa_layers):
        skips.append(feats)
        coords_list.append(coords)
        f = feats if i == 0 else torch.cat(
            [feats, temb[:, None, :].expand(-1, feats.shape[1], -1)], -1)
        mods = list(stage) if isinstance(stage, nn.ModuleList) else [stage]
        for conv in mods[:-1]:
            f = conv(f, coords, run)
        feats, coords = mods[-1](f, coords, run)
    if global_att is not None:
        feats = global_att(feats, run)
    return feats, coords, coords_list, skips


class PVCNNFuse(nn.Module):
    """forward(recon input (B, N, 3 + extra), prior cloud (B, N, 3), t (B,),
    mode) -> (B, N, out); with `project=False` the PVD tower's projections
    are left out, so the PC2 tower and the decoder alone decide."""

    def __init__(self, sa_blocks, fp_blocks, extra: int, embed_dim: int = 64,
                 out: int = 3, use_att: bool = True, dropout: float = 0.1):
        super().__init__()
        pc2 = PVCNN2(sa_blocks, fp_blocks, extra, embed_dim, out, use_att,
                     dropout)
        pvd = PVCNN2(sa_blocks, fp_blocks, 0, embed_dim, out, use_att,
                     dropout)
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.embedf = pc2.embedf
        self.pc2_model_sa_layers = pc2.sa_layers
        self.pc2_model_global_att = pc2.global_att
        self.pvd_model_sa_layers = pvd.sa_layers
        self.pvd_model_global_att = pvd.global_att
        self.fusion_decoder_fp_layers = pc2.fp_layers
        self.classifier = pc2.classifier
        # the PVD tower's features at each skip scale, then its bottleneck
        self.projs = nn.ModuleList(projection(sa[3][-1])
                                   for _, sa in sa_blocks)

    def forward(self, recon_inputs: torch.Tensor, prior: torch.Tensor,
                t: torch.Tensor, mode: str = "fusion_nstep",
                run: Optional[Run] = None,
                project: bool = True) -> torch.Tensor:
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        run = run or Run()
        e = timestep_embedding(self.embed_dim, t)
        temb = F.linear(run.p(e), run.p(self.embedf[0].weight),
                        self.embedf[0].bias)
        temb = F.leaky_relu(temb, 0.1)
        temb = F.linear(run.p(temb), run.p(self.embedf[2].weight),
                        self.embedf[2].bias)
        f_pc2, coords, coords_list, pc2_skips = _encode(
            self.pc2_model_sa_layers, self.pc2_model_global_att,
            recon_inputs, temb, run)
        pc2_skips[0] = recon_inputs[..., 3:]
        feats, skips = f_pc2, pc2_skips
        if project:
            pvd_in = prior[..., :3] if mode == "fusion_nstep" \
                else recon_inputs[..., :3]
            f_pvd, _, _, pvd_skips = _encode(
                self.pvd_model_sa_layers, self.pvd_model_global_att, pvd_in,
                temb, run)
            feats = _project(self.projs[-1], f_pvd, run) + f_pc2
            skips = [pc2_skips[0]] + [
                _project(p, a, run) + b
                for p, a, b in zip(self.projs, pvd_skips[1:], pc2_skips[1:])]
        for k, stage in enumerate(self.fusion_decoder_fp_layers):
            fine = coords_list[-1 - k]
            feats = stage[0](fine, coords, feats, skips[-1 - k], temb, run)
            coords = fine
            for conv in stage[1:]:
                feats = conv(feats, coords, run)
        f = self.classifier[0](feats, run)
        f = run.dropout(f, self.dropout)
        return self.classifier[2](f, run)


def fuse_step(fusion: PVCNNFuse, pc2, ddpm, prior: torch.Tensor,
              recon: torch.Tensor, t: int, z: torch.Tensor, cam: dict,
              cond: torch.Tensor, run: Optional[Run] = None,
              project: bool = True):
    """`nstep_fuse`: both clouds re-centred, the recon one conditioned by
    PC2's projection (`models.PC2.inputs`), one "fusion_nstep" forward at t
    (without the PVD tower's projections where `project` is False) and one
    DDPM step from the recon cloud with noise z -> ((x_prev, c), eps)."""
    prior = prior - prior.mean(dim=1, keepdim=True)
    recon = recon - recon.mean(dim=1, keepdim=True)
    tb = torch.full((recon.shape[0],), int(t), dtype=torch.long,
                    device=recon.device)
    eps = fusion(pc2.inputs(recon, cam, cond), prior, tb, "fusion_nstep",
                 run, project)
    return ddpm.step(eps, int(t), recon, z), eps
