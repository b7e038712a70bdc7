"""The yardstick's arithmetic: the operations of one forward of each
network and the least time the card could take over the launches of the
port's own kernels, both from the configuration's shapes alone.

Operations (2 a multiply-add) follow the port's `bench.forward_flops`
rules, frozen here: a 3x3x3 voxel conv 2 B R^3 27 Cin Cout; a dense or
1x1 layer 2 rows in out; squeeze-excitation its two dense layers on
(B, C); an attention (voxel, global or the ViT's) 4 B S^2 C; the ViT's
patch embedding 2 out Cin p^2. Left out: elementwise work, norms, softmax,
gathers and the geometry kernels' distances.

A kernel's bound is the larger of its bytes over the HBM rate and its
operations over the peak rate of its kind (`chip_smoke.py` phase a's
formulas, frozen): each input read once and each output written once.
Ball query's operations depend on the data (it stops at the 32nd hit) and
are not counted: its bound is its bytes, a lower bound of what it needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

# Published dense peaks (NVIDIA's data sheet, H100 SXM, no sparsity) and
# the HBM rate
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class PVConvShape:
    cin: int
    cout: int
    r: int
    attention: bool
    points: int         # points of the level it runs on


@dataclass(frozen=True)
class Net:
    """The layer shapes of one PVCNN2 forward over `points` points."""
    embed: int
    sa: tuple           # per stage: (convs, (n, m, radius, k, cin, widths))
    global_att: int     # bottleneck channels (0: none)
    bottleneck: int     # bottleneck points
    # per stage: (n_fine, m_coarse, c_coarse, cin, widths, convs)
    fp: tuple
    head: tuple         # (n, cin, 128, out)


def pvcnn2(sa_blocks, fp_blocks, extra: int, embed: int, points: int,
           use_att: bool = True, out: int = 3) -> Net:
    """The original's channel accounting (`pvcnn_utils.py`)."""
    in_ch, n, sa_in, sa, levels = extra + 3, points, [], [], [points]
    for c, (conv, block) in enumerate(sa_blocks):
        sa_in.append(in_ch)
        convs = []
        if conv is not None:
            cout, blocks, r = conv
            for p in range(blocks):
                if c == 0 or p == 0:
                    cin = in_ch if c == 0 or p > 0 else in_ch + embed
                    convs.append(PVConvShape(cin, cout, r, (c + 1) % 2 == 0
                                             and p == 0 and use_att, n))
                in_ch = cout
            cin = in_ch
        else:
            cin = in_ch + embed
        m, radius, k, widths = block
        sa.append((tuple(convs), (n, m, radius, k, cin, tuple(widths))))
        in_ch, n = widths[-1], m
        levels.append(m)
    sa_in[0] = extra
    bottleneck_c = in_ch
    fp = []
    for k, (widths, conv) in enumerate(fp_blocks):
        fine = levels[-2 - k]
        cin = in_ch + sa_in[-1 - k] + embed
        coarse_c = in_ch
        in_ch = widths[-1]
        convs = []
        if conv is not None:
            cout, blocks, r = conv
            for _ in range(blocks):
                convs.append(PVConvShape(in_ch, cout, r, False, fine))
                in_ch = cout
        fp.append((fine, levels[-1 - k], coarse_c, cin, tuple(widths),
                   tuple(convs)))
    return Net(embed, tuple(sa), bottleneck_c if use_att else 0, levels[-1],
               tuple(fp), (points, in_ch, 128, out))


def _mlp(rows: int, cin: int, widths: Sequence[int]) -> int:
    total = 0
    for w in widths:
        total += 2 * rows * cin * w
        cin = w
    return total


def _pvconv_flops(v: PVConvShape, b: int) -> int:
    r3 = v.r ** 3
    f = 2 * b * r3 * 27 * v.cin * v.cout + 2 * b * r3 * 27 * v.cout * v.cout
    if v.attention:
        f += 4 * 2 * b * r3 * v.cout * v.cout + 4 * b * r3 * r3 * v.cout
    f += 2 * b * 2 * v.cout * (v.cout // 8)             # squeeze-excitation
    f += 2 * b * v.points * v.cin * v.cout              # point features
    return f


def pvcnn2_flops(net: Net, b: int) -> int:
    """Operations of one forward at batch `b`."""
    f = 2 * 2 * b * net.embed * net.embed               # embedf
    for convs, (n, m, radius, k, cin, widths) in net.sa:
        f += sum(_pvconv_flops(v, b) for v in convs)
        f += _mlp(b * m * k, cin + 3, widths)
    if net.global_att:
        c, s = net.global_att, net.bottleneck
        f += 4 * 2 * b * s * c * c + 4 * b * s * s * c
    for fine, coarse, cc, cin, widths, convs in net.fp:
        f += _mlp(b * fine, cin, widths)
        f += sum(_pvconv_flops(v, b) for v in convs)
    n, cin, hid, out = net.head
    f += _mlp(b * n, cin, (hid,)) + 2 * b * n * hid * out
    return f


def vit_flops(b: int, image: int, patch: int, d: int, depth: int) -> int:
    t = (image // patch) ** 2 + 1
    f = 2 * b * d * (image // patch) ** 2 * 3 * patch * patch
    per_block = (2 * b * t * d * 3 * d + 4 * b * t * t * d + 2 * b * t * d * d
                 + 2 * 2 * b * t * d * 4 * d)
    return f + depth * per_block


@dataclass(frozen=True)
class Launch:
    kernel: str
    bytes: int
    flops: int
    kind: str           # "bf16" or "f32": the peak its operations count on

    @property
    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.flops / PEAK_FLOPS[self.kind])


def _attention_kernel(s: int, c: int) -> bool:
    """Sites the port's attention kernel serves (`ops.attention`)."""
    return s >= 2048 and c <= 128


def _onehot(bf16: bool, m: int, n: int) -> bool:
    """Blends the port's `interp_mm` kernel serves (`ops.interpolate`)."""
    return bf16 and m >= 128 and n % min(n, 512) == 0


def kernel_launches(net: Net, b: int, bf16: bool,
                    backward: bool = False) -> List[Launch]:
    """The launches of the port's own kernels in one forward (and, with
    `backward`, the own kernels of its backward: the blend's scatter-sum),
    with what each needs."""
    e = 2 if bf16 else 4
    kind = "bf16" if bf16 else "f32"
    out: List[Launch] = []

    def pvconv(v: PVConvShape):
        r3 = v.r ** 3
        out.append(Launch("scatter_mean", b * v.points * v.cin * e
                          + b * v.points * 4 + b * (r3 + 1) * 4
                          + b * r3 * v.cin * e, b * v.points * v.cin * 2,
                          "f32"))
        for cin in (v.cin, v.cout):
            out.append(Launch("conv3d", b * r3 * cin * e
                              + v.cout * cin * 27 * e + v.cout * 4
                              + b * r3 * v.cout * e,
                              2 * 27 * cin * v.cout * r3 * b, kind))
        if v.attention and _attention_kernel(r3, v.cout):
            out.append(Launch("attention", 4 * b * r3 * v.cout * e,
                              4 * b * r3 * r3 * v.cout, kind))

    for convs, (n, m, radius, k, cin, widths) in net.sa:
        for v in convs:
            pvconv(v)
        out.append(Launch("fps", b * n * 12 + b * m * 4,
                          b * (m - 1) * n * 10, "f32"))
        out.append(Launch("ball_query", b * m * 12 + b * n * 12
                          + b * m * k * 4, 0, "f32"))
    if net.global_att and _attention_kernel(net.bottleneck, net.global_att):
        c, s = net.global_att, net.bottleneck
        out.append(Launch("attention", 4 * b * s * c * e, 4 * b * s * s * c,
                          kind))
    for fine, coarse, cc, cin, widths, convs in net.fp:
        out.append(Launch("three_nn", b * fine * 12 + b * coarse * 12
                          + 2 * b * fine * 12, b * fine * coarse * 9, "f32"))
        if _onehot(bf16, coarse, fine):
            out.append(Launch("interp", 2 * b * fine * 12 + b * coarse * cc * 2
                              + b * fine * cc * 2, b * fine * cc * 6, "f32"))
            if backward:
                rows = b * 3 * fine * cc
                out.append(Launch("scatter_sum", rows * 4 + b * 3 * fine * 4
                                  + b * coarse * cc * 4, rows, "f32"))
        for v in convs:
            pvconv(v)
    return out


def bound_s(launches: List[Launch]) -> float:
    return sum(x.bound_s for x in launches)
