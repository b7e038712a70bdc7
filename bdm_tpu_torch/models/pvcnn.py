"""PVCNN2, the PointNet++-with-voxel-convs U-Net of PC2 and PVD
(`bdm_tpu/models/pvcnn.py`), channel-last.

Module names and parameter shapes follow the reference checkpoints
(`sa_layers.*`, `global_att.*`, `fp_layers.*`, `classifier.*`, `embedf.*`;
PVConv `voxel_layers.{0,1,4,5,6,7}` and `point_features`), so a released
state_dict loads directly and `bdm_tpu/utils/convert_torch.py` maps it to
the JAX tree. The timestep embedding is carried as (B, E) and broadcast at
each concat site in the reference's channel position; FP stages never use
attention (the reference's shadowed-list check, replicated).

Point-sharded mode (`sp_group`, the JAX package's `sp_mesh`): each level
of at least `sp_min_points` points is split over the ranks of a process
group (`parallel.point_sharded`). There the PVConvs build their grid from
the shards' partial sums and devoxelize at the shard's points, the SA
module samples, queries and groups across the shards and returns
replicated centres, the FP module interpolates onto the shard's points,
and the GroupNorms of point features take the statistics of the whole.
Levels below the threshold run replicated on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from bdm_tpu_torch import ops
from bdm_tpu_torch.models.graphs import Graphed
from bdm_tpu_torch.models.layers import (SE, Attention, Conv1x1, Dropout,
                                         GroupNormCL, SharedMLP,
                                         get_timestep_embedding,
                                         timestep_mlp)
from bdm_tpu_torch.parallel import point_sharded as psh
from bdm_tpu_torch.utils.spans import span

# (conv_configs, sa_configs) per stage; conv = (out_ch, num_blocks, voxel_res),
# sa = (num_centers, radius, num_neighbors, mlp_channels)
PVCNN_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 3, 16), (256, 0.2, 32, (64, 128))),
    ((128, 3, 8), (64, 0.4, 32, (128, 256))),
    (None, (16, 0.8, 32, (256, 256, 512))),
)
# (fp_mlp_channels, conv_configs) per stage
PVCNN_FP_BLOCKS = (
    ((256, 256), (256, 3, 8)),
    ((256, 256), (256, 3, 8)),
    ((256, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 2, 32)),
)


@dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    resolution: int
    attention: bool


@dataclass(frozen=True)
class SASpec:
    num_centers: int
    radius: float
    num_neighbors: int
    mlp: Tuple[int, ...]


@dataclass(frozen=True)
class SAStageSpec:
    convs: Tuple[ConvSpec, ...]
    sa: SASpec
    out_channels: int


@dataclass(frozen=True)
class FPStageSpec:
    fp_mlp: Tuple[int, ...]
    convs: Tuple[ConvSpec, ...]


@dataclass(frozen=True)
class PVCNN2Specs:
    sa_stages: Tuple[SAStageSpec, ...]
    fp_stages: Tuple[FPStageSpec, ...]
    sa_in_channels: Tuple[int, ...]
    channels_sa_features: int


def build_pvcnn2_specs(sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                       extra_feature_channels: int = 3,
                       use_att: bool = True, width_multiplier: int = 1,
                       voxel_resolution_multiplier: int = 1) -> PVCNN2Specs:
    """The reference's channel accounting (`pvcnn_utils.py:72-168`):
    stage 0 keeps all its PVConvs, later stages only the first; attention
    on the first conv of odd stages; FP stages never attend. The width
    multiplier scales every conv and MLP width, the resolution multiplier
    every voxel grid."""
    r, vr = width_multiplier, voxel_resolution_multiplier
    in_channels = extra_feature_channels + 3
    sa_stages, sa_in_channels = [], []
    for c, (conv_configs, sa_configs) in enumerate(sa_blocks):
        sa_in_channels.append(in_channels)
        convs = []
        if conv_configs is not None:
            out_ch, num_blocks, res = conv_configs
            out_ch = int(r * out_ch)
            for p in range(num_blocks):
                attention = ((c + 1) % 2 == 0) and use_att and p == 0
                if c == 0 or p == 0:
                    convs.append(ConvSpec(out_ch, int(vr * res), attention))
                in_channels = out_ch
        num_centers, radius, num_neighbors, mlp = sa_configs
        mlp = tuple(int(r * oc) for oc in mlp)
        sa_stages.append(SAStageSpec(
            tuple(convs), SASpec(num_centers, radius, num_neighbors,
                                 tuple(mlp)), mlp[-1]))
        in_channels = mlp[-1]
    sa_in_channels[0] = extra_feature_channels
    fp_stages = []
    for fp_mlp, conv_configs in fp_blocks:
        fp_mlp = tuple(int(r * oc) for oc in fp_mlp)
        convs = []
        if conv_configs is not None:
            out_ch, num_blocks, res = conv_configs
            convs = [ConvSpec(int(r * out_ch), int(vr * res),
                              False)] * num_blocks
        fp_stages.append(FPStageSpec(tuple(fp_mlp), tuple(convs)))
    return PVCNN2Specs(tuple(sa_stages), tuple(fp_stages),
                       tuple(sa_in_channels), in_channels)


def tap_weights(weight: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Input rows lo:hi of every tap of a (Cout, Cin, 3, 3, 3) conv weight
    -> (hi - lo, 27 * Cout), tap-major blocks in (kd, kh, kw) order: the
    layout `tap_shift_sum` reads and the precontraction builds."""
    cout = weight.shape[0]
    return weight[:, lo:hi].permute(1, 2, 3, 4, 0).reshape(-1, 27 * cout)


class VoxConv(nn.Module):
    """3x3x3 SAME conv with the reference Conv3d's parameters
    (weight (Cout, Cin, 3, 3, 3), bias), on channel-last grids.

    `forward_pre_tap` is the precontracted form of the first conv of
    stage 0 (`bdm_tpu/models/pvcnn.py::VoxConv`, `pre_tap`): the taps of
    the conditioning rows were contracted per point once a trajectory
    (`PC2Model.precontract_cond`), so a step adds the x_t rows' taps,
    scatter-means the 27 * Cout tap values and shift-sums them."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        return ops.voxel_conv3d(grid, self.weight, self.bias)

    def forward_pre_tap(self, pre_tap: torch.Tensor, xt: torch.Tensor,
                        ctx: ops.VoxelContext, resolution: int,
                        dtype: torch.dtype) -> torch.Tensor:
        """pre_tap (B, N, 27 * Cout), xt (B, N, 3) -> the conv of the
        voxelized input, (B, R, R, R, Cout) in `dtype`."""
        cout, r = self.weight.shape[0], resolution
        dt = pre_tap.dtype
        tap = pre_tap + xt.to(dt) @ tap_weights(self.weight, 0, 3).to(dt)
        grid = ops.scatter_mean_contributions(tap, ctx, r)
        out = ops.tap_shift_sum(
            grid.reshape((tap.shape[0],) + (r,) * 3 + (27 * cout,)), cout)
        return (out + self.bias.float()).to(dtype)


class PVConv(nn.Module):
    """Point-voxel conv (`modules/pvconv.py:65-97`): voxelize -> [conv ->
    GN -> swish -> dropout -> conv -> GN -> attention | swish] ->
    devoxelize, gated by SE on the points, plus the pointwise SharedMLP
    branch: the devoxelization, the gate and the sum are one call
    (`ops.gated_devoxelize`).

    Voxel grids run in the compute dtype (bf16 in production); geometry
    stays float32."""

    def __init__(self, cin: int, cout: int, resolution: int,
                 attention: bool, dtype=None, dropout: float = 0.1):
        super().__init__()
        self.resolution = resolution
        self.attention = attention
        self.dtype = dtype
        self.voxel_layers = nn.ModuleList([
            VoxConv(cin, cout), GroupNormCL(8, cout), nn.SiLU(),
            Dropout(dropout), VoxConv(cout, cout), GroupNormCL(8, cout),
            Attention(cout, 8, kdims=3, dtype=dtype) if attention
            else nn.SiLU(),
            SE(cout, dtype=dtype)])
        self.point_features = SharedMLP(cin, (cout,), kdims=1, dtype=dtype)

    def forward(self, features: torch.Tensor, ctx: ops.VoxelContext,
                pre_tap: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        """With `pre_tap` the first conv takes its precontracted form
        (`VoxConv.forward_pre_tap`) and skips the voxelization. With
        `group` the features are a point shard, `ctx` is the stage's
        `ShardedVoxelContext` and the grid is replicated."""
        vl = self.voxel_layers
        dt = self.dtype or torch.float32
        r = self.resolution
        if group is None and pre_tap is not None:
            g = vl[0].forward_pre_tap(pre_tap, features[..., :3], ctx, r, dt)
        else:
            with span("pvconv.voxelize"):
                g = (ops.avg_voxelize(features, ctx, r, out_dtype=dt)
                     if group is None else
                     psh.sharded_voxel_grid(features, ctx, r, group, dt))
            g = vl[0](g)        # the grid is freed as soon as the conv is done
        g = vl[3](vl[1](g, dt, silu=True))
        # the voxel attention takes the norm without its SiLU
        g = vl[5](vl[4](g), dt, silu=not self.attention)
        if self.attention:
            b, c = g.shape[0], g.shape[-1]
            g = vl[6](g.reshape(b, r ** 3, c)).reshape(g.shape)
        with span("pvconv.se"):
            gate = vl[7](g)                                      # (B, C)
        pf = self.point_features(features, group)
        # under `group` the grid is replicated and the points local: the
        # same call
        with span("pvconv.devoxelize"):
            return ops.gated_devoxelize(g, ctx.norm_coords, gate, pf)


class PointNetSA(nn.Module):
    """Set abstraction (`modules/pointnet.py:49-93`): FPS centres ->
    ball-query grouping with relative coordinates -> SharedMLP -> max."""

    def __init__(self, spec: SASpec, cin: int, dtype=None):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.mlps = nn.ModuleList(
            [SharedMLP(cin + 3, spec.mlp, kdims=2, dtype=dtype)])

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                group=None):
        """With `group` the points are a shard; the centres and their
        features come back replicated."""
        s = self.spec
        dt = self.dtype or torch.float32
        both = torch.cat([coords.to(dt), features.to(dt)], -1)
        with span("sa.group"):
            if group is None:
                idx = ops.furthest_point_sample(coords, s.num_centers)
                centers = ops.gather(coords, idx)                # (B, M, 3)
                nbr = ops.ball_query(centers, coords, s.radius,
                                     s.num_neighbors)
                both = ops.grouping(both, nbr)                   # (B, M, U, .)
            else:
                idx = psh.fps_point_sharded(coords, s.num_centers, group)
                centers = psh.gather_point_sharded(coords, idx, group)
                nbr = psh.ball_query_point_sharded(centers, coords, s.radius,
                                                   s.num_neighbors, group)
                both = psh.grouping_point_sharded(both, nbr, group)
        nbr_feats = torch.cat(
            [both[..., :3] - centers[:, :, None, :].to(dt), both[..., 3:]],
            dim=-1)
        f = self.mlps[0](nbr_feats).amax(dim=2).to(dt)
        return f, centers


class PointNetFP(nn.Module):
    """Feature propagation (`modules/pointnet.py:96-113`): 3-NN
    interpolation, then [features | temb | skip] -> SharedMLP."""

    def __init__(self, cin: int, mlp, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(cin, mlp, kdims=1, dtype=dtype)

    def forward(self, fine_coords, coarse_coords, coarse_features, skip,
                temb, group=None):
        """Replicated coarse centres and features; with `group` the fine
        points (and `skip`) are a shard: the blend is local to it."""
        dt = self.dtype or torch.float32
        with span("fp.interpolate"):
            f = ops.three_nn_interpolate(fine_coords, coarse_coords,
                                         coarse_features)
        n = fine_coords.shape[1]
        parts = [f.to(dt), temb[:, None, :].to(dt).expand(-1, n, -1)]
        if skip.shape[-1] > 0:
            parts.append(skip.to(dt))
        return self.mlp(torch.cat(parts, dim=-1), group).to(dt)


def _stage_parts(layer):
    """A stage is a Sequential of its PVConvs around the SA or FP module
    (the reference's layout), or the bare module when it has no conv."""
    return list(layer) if isinstance(layer, nn.Sequential) else [layer]


def _voxel_convs(convs, features, coords, pre_tap=None, group=None):
    """Run a stage's PVConvs over one shared voxel context; `pre_tap`
    serves the first; `group`: the stage's points are a shard."""
    if convs:
        r = convs[0].resolution
        with span("voxel.context"):
            ctx = (ops.make_voxel_context(coords, r) if group is None
                   else psh.sharded_voxel_context(coords, r, group))
        for p, conv in enumerate(convs):
            features = conv(features, ctx, pre_tap if p == 0 else None,
                            group)
    return features


class PVCNNEncoder:
    """The SA tower and the global attention
    (`bdm_tpu/models/pvcnn.py::PVCNNEncoder`).

    Not an `nn.Module`: the network that owns a tower registers
    `sa_layers` and `global_att` under the names its checkpoint uses
    (`sa_layers` in PVCNN2, `pc2_model_sa_layers` in the fusion net); this
    object builds the modules and runs them."""

    def __init__(self, specs: PVCNN2Specs, embed_dim: int, use_att: bool,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        self.dtype = dtype
        sa_layers = []
        for i, stage in enumerate(specs.sa_stages):
            cin = specs.sa_in_channels[i] + (3 if i == 0 else embed_dim)
            convs = []
            for cs in stage.convs:
                convs.append(PVConv(cin, cs.out_channels, cs.resolution,
                                    cs.attention, dtype, dropout))
                cin = cs.out_channels
            sa = PointNetSA(stage.sa, cin, dtype)
            sa_layers.append(nn.Sequential(*convs, sa) if convs else sa)
        self.sa_layers = nn.ModuleList(sa_layers)
        self.global_att = (Attention(specs.channels_sa_features, 8, kdims=1,
                                     dtype=dtype) if use_att else None)

    def __call__(self, features: torch.Tensor, coords: torch.Tensor,
                 temb: torch.Tensor, pre_tap: Optional[torch.Tensor] = None,
                 groups=None):
        """features (B, N, C0), coords (B, N, 3) float32, temb (B, E) ->
        (bottleneck features, its coords, temb, the coords and the input
        features of every stage). `pre_tap`: the precontracted taps of
        stage 0's first conv (`VoxConv.forward_pre_tap`).

        `groups` (`PVCNN2.sp_groups`): the process group of each stage's
        level whose points are sharded over it, None where the level is
        replicated; the inputs are then this rank's shard, the stage lists
        hold each level as it ran, and the bottleneck is replicated."""
        dt = self.dtype or torch.float32
        coords_list, skips = [], []
        groups = groups or [None] * len(self.sa_layers)
        for i, layer in enumerate(self.sa_layers):
            group = groups[i]
            if i > 0 and group is not None:   # this rank's replicated centres
                features = psh.own_rows(features, group)
                coords = psh.own_rows(coords, group)
            skips.append(features)
            coords_list.append(coords)
            if i == 0:
                f = features
            else:
                n = features.shape[1]
                f = torch.cat([features.to(dt),
                               temb[:, None, :].to(dt).expand(-1, n, -1)], -1)
            *convs, sa = _stage_parts(layer)
            features, coords = sa(_voxel_convs(
                convs, f, coords, pre_tap if i == 0 else None, group),
                coords, group)
        if self.global_att is not None:
            features = self.global_att(features).to(dt)
        return features, coords, temb, coords_list, skips


class PVCNNDecoder:
    """The FP tower and the classifier head
    (`bdm_tpu/models/pvcnn.py::PVCNNDecoder`); like `PVCNNEncoder`, its
    owner registers `fp_layers` and `classifier`."""

    def __init__(self, specs: PVCNN2Specs, embed_dim: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        ch = specs.channels_sa_features
        fp_layers = []
        for k, stage in enumerate(specs.fp_stages):
            fp = PointNetFP(ch + embed_dim + specs.sa_in_channels[-1 - k],
                            stage.fp_mlp, dtype)
            ch = stage.fp_mlp[-1]
            convs = []
            for cs in stage.convs:
                convs.append(PVConv(ch, cs.out_channels, cs.resolution,
                                    False, dtype, dropout))
                ch = cs.out_channels
            fp_layers.append(nn.Sequential(fp, *convs))
        self.fp_layers = nn.ModuleList(fp_layers)
        self.classifier = nn.Sequential(
            SharedMLP(ch, (128,), kdims=1, dtype=dtype), Dropout(dropout),
            Conv1x1(128, out_channels, 1))

    def __call__(self, features: torch.Tensor, coords: torch.Tensor,
                 temb: torch.Tensor, coords_list, skips,
                 groups=None) -> torch.Tensor:
        """The encoder's outputs (skips[0] replaced by the caller with the
        input's extra channels) -> (B, N, out_channels) float32. `groups`:
        the process group of each level whose points are a shard
        (`PVCNN2.sp_groups`); the output is then the finest level's
        shard."""
        groups = groups or [None] * len(coords_list)
        for k, layer in enumerate(self.fp_layers):
            fp, *convs = _stage_parts(layer)
            fine, group = coords_list[-1 - k], groups[-1 - k]
            if k > 0 and groups[-k] is not None:    # a sharded coarse level
                features = psh.all_rows(features, groups[-k])
                coords = psh.all_rows(coords, groups[-k])
            features = fp(fine, coords, features, skips[-1 - k], temb, group)
            coords = fine
            features = _voxel_convs(convs, features, coords, group=group)
        f = self.classifier[0](features, groups[0]).float()
        return self.classifier[2](self.classifier[1](f), torch.float32)


@torch.no_grad()
def init_uniform(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded stand-in weights: fan-in uniform matrices, zero biases, unit
    norm scales."""
    for p in module.parameters():
        if p.ndim >= 2:
            bound = 1.0 / np.sqrt(int(np.prod(p.shape[1:])))
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        else:
            p.zero_()
    for m in module.modules():
        if isinstance(m, GroupNormCL):
            m.weight.fill_(1.0)


class PVCNN2(Graphed):
    """The noise-prediction backbone (`pvcnn.py:10-150`):
    forward(inputs (B, N, 3 + S), t (B,)) -> (B, N, out_channels) float32.
    Coordinates are the first 3 input channels. The module leaves its
    constructor in `eval()` mode (dropout off); a training step switches
    to `train()` and back.

    `sp_group`: a process group over whose ranks the point axis of every
    level of at least `sp_min_points` points is sharded (the module
    docstring); `inputs` and the output are then this rank's contiguous
    shard of the points. The network may not be shardable at the input
    level (too few points, or a precontracted stage 0, which keeps the
    unsharded path as in the JAX package): it then runs replicated on the
    whole cloud and returns this rank's rows."""

    def __init__(self, out_channels: int = 3, embed_dim: int = 64,
                 extra_feature_channels: int = 3, use_att: bool = True,
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 classifier_init_scale: Optional[float] = 1e-6,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1, sp_group=None,
                 sp_min_points: int = 2048):
        super().__init__()
        self.embed_dim = embed_dim
        self.sp_group = sp_group
        self.sp_min_points = sp_min_points
        self.classifier_init_scale = classifier_init_scale
        self.dtype = dtype
        self.specs = build_pvcnn2_specs(
            sa_blocks, fp_blocks, extra_feature_channels, use_att,
            width_multiplier, voxel_resolution_multiplier)
        self.embedf = timestep_mlp(embed_dim)
        self.encoder = PVCNNEncoder(self.specs, embed_dim, use_att, dtype,
                                    dropout)
        self.sa_layers = self.encoder.sa_layers
        if use_att:
            self.global_att = self.encoder.global_att
        self.decoder = PVCNNDecoder(self.specs, embed_dim, out_channels,
                                    dtype, dropout)
        self.fp_layers = self.decoder.fp_layers
        self.classifier = self.decoder.classifier
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from `seed` (`init_uniform`); the classifier
        head N(0, scale^2) when `classifier_init_scale` is set (PC2's 1e-6
        re-init, `point_cloud_model.py:38-39`)."""
        g = torch.Generator().manual_seed(seed)
        init_uniform(self, g)
        if self.classifier_init_scale is not None:
            head = self.classifier[2]
            for p in (head.weight, head.bias):
                p.copy_(torch.randn(p.shape, generator=g)
                        * self.classifier_init_scale)

    def sp_groups(self, n: int) -> list:
        """The process group of each stage's level of a cloud of `n` points
        (None: that level runs replicated)."""
        counts = [n] + [st.sa.num_centers for st in self.specs.sa_stages[:-1]]
        return [self.sp_group if psh.sp_active(self.sp_group, c,
                                               self.sp_min_points) else None
                for c in counts]

    def forward(self, inputs: torch.Tensor, t: torch.Tensor,
                pre_tap: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`pre_tap` (B, N, 27 * Cout0): stage 0's first conv in its
        precontracted form. Unsharded, the forward replays a captured CUDA
        graph where `models.graphs`'s rule allows it (on the card, autograd
        off, `eval()`, spans off, no hook inside), else runs eagerly."""
        with span("network"):
            group = self.sp_group
            if group is None:
                return self.graphs(self, self._forward, inputs, t, pre_tap)
            groups = self.sp_groups(inputs.shape[1]
                                    * dist.get_world_size(group))
            if pre_tap is not None or groups[0] is None:
                pre_tap = (None if pre_tap is None
                           else psh.all_rows(pre_tap, group))
                return psh.own_rows(self._forward(
                    psh.all_rows(inputs, group), t, pre_tap), group)
            return self._forward(inputs, t, pre_tap, groups)

    def _forward(self, inputs, t, pre_tap, groups=None) -> torch.Tensor:
        temb = self.embedf(get_timestep_embedding(self.embed_dim, t))
        coords = inputs[..., :3].float()
        features = inputs if self.dtype is None else inputs.to(self.dtype)
        feats, ccoords, temb, coords_list, skips = self.encoder(
            features, coords, temb, pre_tap, groups)
        skips[0] = inputs[..., 3:]
        return self.decoder(feats, ccoords, temb, coords_list, skips, groups)
