"""The nine Hopper kernels of `bdm_tpu_torch` against their plain PyTorch
versions, on the card. Without a CUDA device every test here skips (a
CUDA kernel has no CPU mode). This file imports torch only, so it also
runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: indices exact; float32 results 1e-5 of the largest value (the
same float32 operations, summed in another order for the conv and
attention); bfloat16 outputs 1e-2 of the largest value (one bfloat16
rounding of sums that differ in their last float32 bits); the bf16
three-neighbour blend 4e-3 (one bfloat16 ulp) and, at the two FP stages of
the paths and the edge shapes of `chip_smoke.INTERP_SHAPES`, bit for bit
(its products and sums are rounded one by one in the plain version's
order), with the kernel it took ("vec" or the one-channel "scalar"); the
unsorted segment sum 1e-5 against the card's `index_add_` (atomics, an order
that changes from run to run) and bit for bit against the CPU's (index
order, the kernel's own), also with every row on one id, with ids -1 and S
(dropped), with S 40,000 and with N no multiple of the CSR's tile; the
blend's gradient through it at the two FP stages that take it, 1e-2 (bf16)
against the plain blend under autograd; ball query at every SA level on
random, lattice and duplicate clouds, at N < U and on the lattice at r = 1.0
(d2 = r2 exactly is out); three-NN indices exact and weights 1e-6 relative
at every FP level on random, lattice and duplicate clouds and with fewer
centres than three and than a query's lanes; gradients 1e-4 (float32)
against the plain versions under PyTorch's autograd. bfloat16 attention (C a
multiple of 8) and every bfloat16 conv run on the tensor cores, float32 on
the CUDA cores: both are held here, at ragged and narrow shapes too, and the
counters say which kernel a call took. FPS is held on tie-heavy clouds (the
integer lattice, exact duplicates) at every PVCNN2 level and at N that is no
multiple of the block; the scatter-mean with every point in one voxel and
with every point in a voxel of its own, at row widths that take each vector
width, bit for bit against the plain version on the CPU (one rounding of
float32 sums in the same order). Float32 attention and conv3d are held at
every shape `chip_smoke.py` lists for the paths (`ATTNS`, `CONVS`), FPS past
the points a thread holds in registers (`FPS_LARGE`, up to N 40,000), and a
float32 PC2 loss with dropout on is a function of its `TrainNoise` seed
(1e-6 relative). GroupNorm + SiLU at every (S, C) a production PC2 and PVD
forward hands it, float32 within 1e-5 of the largest value (the last bits
of its statistics, the fast exp of the SiLU), bf16 within one bf16 rounding
of the float32 form at every element; on an offset 1e3 times the spread;
bit-equal over two calls; 63 calls of two launches in a bf16 PC2 forward,
with and without autograd; its gradients at every path shape against
autograd through the plain form; the point-sharded norm on two ranks
against the unsharded one, forward and backward.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from bdm_tpu_torch import ops
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import (_lib, attention as k_attn,
                                    ball_query as k_bq,
                                    conv3d as k_conv, fps as k_fps,
                                    groupnorm as k_gn, interp as k_interp,
                                    scatter_sum as k_ss, three_nn as k_tnn,
                                    voxelize as k_vox)

pytestmark = pytest.mark.cuda

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _cloud(dev, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


def test_geometry_kernels_exact(dev):
    x = _cloud(dev, 2, 2048, 3)            # two point tiles per scan
    idx = k_fps.furthest_point_sample(x, 256)
    assert torch.equal(idx, k_fps.furthest_point_sample_plain(x, 256))
    c = ops.gather(x, idx).contiguous()
    for r in (0.1, 0.4):
        assert torch.equal(k_bq.ball_query(c, x, r, 32),
                           k_bq.ball_query_plain(c, x, r, 32))
    i, w = k_tnn.three_nn(x, c)
    pi, pw = k_tnn.three_nn_plain(x, c)
    assert torch.equal(i, pi)
    assert _rel(w, pw) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_conv_attention(dev, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    x = _cloud(dev, 2, 1024, 3, seed=1)
    ctx = ops.make_voxel_context(x, 8)
    f = _cloud(dev, 2, 1024, 40, seed=2).to(dtype)
    args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 8, dtype)
    grid = k_vox.scatter_mean(*args, ids=ctx.ids)
    assert grid.dtype == dtype
    assert _rel(grid, k_vox.scatter_mean_plain(*args)) < tol
    wt = _cloud(dev, 16, 40, 3, 3, 3, seed=3) * 0.05
    bias = _cloud(dev, 16, seed=4)
    assert _rel(k_conv.conv3d(grid, wt, bias),
                k_conv.conv3d_plain(grid, wt, bias)) < tol
    q = (_cloud(dev, 2, 600, 64, seed=5) * 0.3).to(dtype)
    assert _rel(k_attn.attention(q, q, q),
                k_attn.attention_plain(q, q, q)) < tol


@pytest.mark.parametrize("n,m,c", [(1024, 256, 256), (512, 128, 40),
                                   (200, 128, 12)],
                         ids=["C256", "C40", "C12-scalar"])
def test_interp_mm(dev, n, m, c):
    x = _cloud(dev, 2, n, 3, seed=6)
    ctr = _cloud(dev, 2, m, 3, seed=7)
    idx, w = k_tnn.three_nn(x, ctr)
    f = _cloud(dev, 2, m, c, seed=8).to(torch.bfloat16)
    out = k_interp.interp_mm(idx, w, f)
    assert out.dtype == torch.bfloat16 and out.shape == (2, n, c)
    assert _rel(out, k_interp.interp_mm_plain(idx, w, f)) < 4e-3
    with pytest.raises(TypeError):
        k_interp.interp_mm(idx, w, f.float())


@pytest.mark.parametrize("b,n,m,c", chip_smoke.INTERP_SHAPES,
                         ids=lambda v: str(v))
def test_interp_mm_bit_equal(dev, b, n, m, c):
    """The blend is the plain version's bit for bit at the two FP stages of
    the paths and the edge shapes of `chip_smoke.INTERP_SHAPES`, and the
    call counts under its kernel ("vec", or "scalar" where C % 8 != 0)."""
    lib = _lib.library()
    assert (lib.bdm_interp_threads(), lib.bdm_interp_rows()) == (
        k_interp.THREADS, k_interp.ROWS)
    x = _cloud(dev, b, n, 3, seed=6)
    idx, w = k_tnn.three_nn(x, _cloud(dev, b, m, 3, seed=7))
    f = _cloud(dev, b, m, c, seed=8).to(torch.bfloat16)
    kernels.reset_counts()
    out = k_interp.interp_mm(idx, w, f)
    assert torch.equal(out, k_interp.interp_mm_plain(idx, w, f))
    path = "scalar" if c % 8 else "vec"
    assert kernels.path_counts()["interp_mm"] == {
        p: int(p == path) for p in k_interp.PATHS}


def test_launch_counters(dev):
    kernels.reset_counts()
    x = _cloud(dev, 1, 256, 3)
    k_fps.furthest_point_sample(x, 16)
    k_fps.furthest_point_sample_plain(x, 16)
    assert kernels.counts()["fps"] == (1, 1)


@pytest.mark.parametrize("n,s,c,dtype", [
    (3072, 256, 256, torch.float32), (1500, 100, 40, torch.float32),
    (5000, 64, 300, torch.float32), (3072, 256, 256, torch.bfloat16),
    (12288, 1024, 128, torch.float32), (12288, 1024, 128, torch.bfloat16),
    (5000, 40000, 40, torch.float32), (1000, 16, 8, torch.bfloat16)],
    ids=["path", "ragged", "wide-two-passes", "bf16-rows", "main",
         "main-bf16", "S40000", "tile-ragged"])
def test_scatter_sum(dev, n, s, c, dtype):
    f = _cloud(dev, 2, n, c, seed=9).to(dtype)
    ids = torch.randint(0, s, (2, n), generator=torch.Generator()
                        .manual_seed(10)).to(dev, torch.int32)
    ids[:, :50] = 7                       # a crowded segment
    ids[ids == 3] = 4                     # and an empty one
    out = k_ss.scatter_sum(f, ids, s)
    assert out.dtype == torch.float32 and out.shape == (2, s, c)
    assert not out[:, 3].any()
    assert _rel(out, k_ss.scatter_sum_plain(f, ids, s)) < 1e-5
    assert torch.equal(out.cpu(),
                       k_ss.scatter_sum_plain(f.cpu(), ids.cpu(), s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["one-id", "out-of-range"])
def test_scatter_sum_extremes(dev, layout, dtype):
    """Every row on one id (a run of all N rows), or ids -1 and S in both
    batch elements (dropped); N 12,288, no multiple of the tile when one
    row is cut: the CPU's `index_add_` bit for bit."""
    for n in (12288, 12287):
        f = _cloud(dev, 2, n, 128, seed=11).to(dtype)
        if layout == "one-id":
            ids = torch.full((2, n), 9, dtype=torch.int32, device=dev)
        else:
            ids = torch.randint(0, 1024, (2, n), generator=torch.Generator()
                                .manual_seed(12)).to(dev, torch.int32)
            ids[:, ::5] = -1
            ids[:, 2::9] = 1024
        out = k_ss.scatter_sum(f, ids, 1024)
        assert torch.equal(out.cpu(),
                           k_ss.scatter_sum_plain(f.cpu(), ids.cpu(), 1024))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_raw_sums(dev, dtype):
    """`divide=False`: the raw-sum store, the means times the counts."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    x = _cloud(dev, 2, 1024, 3, seed=1)
    ctx = ops.make_voxel_context(x, 8)
    f = _cloud(dev, 2, 1024, 40, seed=2).to(dtype)
    args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 8, torch.float32)
    sums = k_vox.scatter_mean(*args, divide=False, ids=ctx.ids)
    assert _rel(sums, k_vox.scatter_mean_plain(*args, divide=False)) < tol
    counts = (ctx.voxel_lo[:, 1:] - ctx.voxel_lo[:, :-1]).reshape(2, 8, 8, 8)
    assert _rel(sums, k_vox.scatter_mean(*args, ids=ctx.ids)
                * counts[..., None]) < tol


def test_gradients_through_the_kernels(dev):
    """Forward through each kernel, backward through its rule, against the
    plain version under autograd; the blend's backward launches
    `scatter_sum`."""
    x = _cloud(dev, 2, 1024, 3, seed=1)
    ctx = ops.make_voxel_context(x, 8)
    wt = (_cloud(dev, 16, 40, 3, 3, 3, seed=3) * 0.05).requires_grad_()
    bias = _cloud(dev, 16, seed=4).requires_grad_()
    f = _cloud(dev, 2, 1024, 40, seed=2).requires_grad_()
    q = (_cloud(dev, 2, 2048, 16, seed=5) * 0.3).requires_grad_()
    grads = []
    for kernel in (True, False):
        for t in (f, wt, bias, q):
            t.grad = None
        a = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 8, torch.float32)
        if kernel:
            g = k_conv.conv3d(k_vox.scatter_mean(*a, ids=ctx.ids), wt, bias)
            o = k_attn.attention(q, q, q)
        else:
            g = k_conv.conv3d_plain(k_vox.scatter_mean_plain(*a), wt, bias)
            o = k_attn.attention_plain(q, q, q)
        (g.square().sum() + o.square().sum()).backward()
        grads.append([t.grad.clone() for t in (f, wt, bias, q)])
    for got, want in zip(*grads):
        assert _rel(got, want) < 1e-4
    ctr = _cloud(dev, 2, 256, 3, seed=7)
    idx, w = k_tnn.three_nn(x, ctr)
    fb = _cloud(dev, 2, 256, 64, seed=8).to(torch.bfloat16).requires_grad_()
    kernels.reset_counts()
    k_interp.interp_mm(idx, w, fb).float().square().sum().backward()
    got = fb.grad.clone()
    assert kernels.counts()["scatter_sum"] == (1, 0)
    fb.grad = None
    k_interp.interp_mm_plain(idx, w, fb).float().square().sum().backward()
    assert got.dtype == torch.bfloat16 and _rel(got, fb.grad) < 1e-2


@pytest.mark.parametrize("s,c,scale", [
    (729, 16, 1.0), (729, 32, 1.0), (729, 128, 0.3), (64, 16, 1.0),
    (125, 64, 0.5), (300, 48, 0.5), (2048, 8, 1.0), (200, 12, 1.0)],
    ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_ragged_and_narrow(dev, dtype, s, c, scale):
    """S that is no multiple of the key or the query tile, C below and at
    the kernel's widest, peaked rows; C 12 takes the CUDA cores."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    q, k, v = ((_cloud(dev, 3, s, c, seed=20 + i) * scale).to(dtype)
               for i in range(3))
    kernels.reset_counts()
    out = k_attn.attention(q, k, v)
    assert torch.isfinite(out).all()
    assert _rel(out, k_attn.attention_plain(q, k, v)) < tol
    path = k_attn.kernel_path(dtype, s, c)
    assert path == ("tc" if dtype == torch.bfloat16 and c % 8 == 0
                    else "simt")
    assert kernels.path_counts()["attention"] == {
        "tc": int(path == "tc"), "simt": int(path == "simt")}
    assert bool(_lib.library().bdm_attention_path(
        _lib.DTYPE_CODES[dtype], s, c)) == (path == "tc")


@pytest.mark.parametrize("cin,cout,r", [
    (3, 32, 9), (6, 8, 5), (390, 32, 9), (64, 130, 9), (16, 7, 5),
    (40, 64, 8), (1, 1, 1), (128, 128, 9)], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_ragged_and_narrow(dev, dtype, cin, cout, r):
    """Grids ragged in all three axes of the block's tile, Cin that is odd,
    even and a multiple of 8 (the three ways the halo is staged), Cout that
    is odd or no multiple of the N tile."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    x = _cloud(dev, 2, r, r, r, cin, seed=30).to(dtype)
    wt = _cloud(dev, cout, cin, 3, 3, 3, seed=31) * (27 * cin) ** -0.5
    bias = _cloud(dev, cout, seed=32) * 0.1
    kernels.reset_counts()
    out = k_conv.conv3d(x, wt, bias)
    assert out.shape == (2, r, r, r, cout) and torch.isfinite(out).all()
    assert _rel(out, k_conv.conv3d_plain(x, wt, bias)) < tol
    tc = dtype == torch.bfloat16
    assert kernels.path_counts()["conv3d"] == {"tc": int(tc),
                                               "simt": int(not tc)}
    lib = _lib.library()
    assert bool(lib.bdm_conv3d_path(_lib.DTYPE_CODES[dtype], cin, cout,
                                    r)) == tc
    assert lib.bdm_conv3d_n_tile(cout) == k_conv.n_tile(cout)


def test_bf16_calls_take_the_tensor_cores(dev):
    """The production shapes at bfloat16 launch the tensor-core kernels
    and nothing else; the packed weights are made once a weight."""
    kernels.reset_counts()
    q = (_cloud(dev, 2, 4096, 64, seed=5) * 0.3).to(torch.bfloat16)
    k_attn.attention(q, q, q)
    x = _cloud(dev, 2, 16, 16, 16, 128, seed=6).to(torch.bfloat16)
    wt = _cloud(dev, 64, 128, 3, 3, 3, seed=7) * 0.02
    bias = _cloud(dev, 64, seed=8)
    for _ in range(3):
        k_conv.conv3d(x, wt, bias)
    assert kernels.path_counts() == {
        "conv3d": {"tc": 3, "simt": 0}, "attention": {"tc": 1, "simt": 0},
        "interp_mm": {"vec": 0, "scalar": 0}}
    assert kernels.counts()["conv3d"] == (3, 0)
    assert k_conv.packs == 1
    with torch.no_grad():
        wt.mul_(2.0)
    doubled = k_conv.conv3d(x, wt, bias)
    assert k_conv.packs == 2
    assert _rel(doubled, k_conv.conv3d_plain(x, wt, bias)) < 1e-2


@pytest.mark.parametrize("cin", [3, 6])
def test_conv3d_takes_a_batch_slice_of_an_odd_grid(dev, cin):
    """A contiguous batch slice of an odd grid with a narrow Cin starts at
    no multiple of 16 bytes: the halo is staged by 2- or 4-byte copies there,
    which need no more."""
    whole = _cloud(dev, 3, 5, 5, 5, cin, seed=40).to(torch.bfloat16)
    x = whole[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    wt = _cloud(dev, 7, cin, 3, 3, 3, seed=41) * (27 * cin) ** -0.5
    bias = _cloud(dev, 7, seed=42) * 0.1
    out = k_conv.conv3d(x, wt, bias)
    assert _rel(out, k_conv.conv3d_plain(x, wt, bias)) < 1e-2


LEVELS = [(4096, 1024), (1024, 256), (256, 64), (64, 16)]


def _tie_cloud(dev, kind, n, b=4):
    if kind == "lattice":        # 64 points repeated: exactly equal distances
        g = torch.stack(torch.meshgrid(*[torch.arange(4.0)] * 3,
                                       indexing="ij"), -1).reshape(-1, 3)
        return g.repeat(-(-n // 64), 1)[:n].expand(b, n, 3).contiguous().to(
            dev)
    half = _cloud(dev, b, -(-n // 2), 3, seed=n)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(n))
    return torch.cat([half, half.flip(1)], 1)[:, perm.to(dev)].contiguous()


@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates"])
@pytest.mark.parametrize("n,m,r", [(4096, 1024, 0.1), (1024, 256, 0.2),
                                   (256, 64, 0.4), (64, 16, 0.8),
                                   (2048, 1024, 0.1)], ids=lambda v: str(v))
def test_ball_query_at_every_level(dev, kind, n, m, r):
    """The SA levels of PC2 and the first of PVD at twice the width, U 32,
    centres by FPS, on random and tie-heavy clouds."""
    x = (_cloud(dev, 4, n, 3, seed=n) * 0.3 if kind == "random"
         else _tie_cloud(dev, kind, n))
    c = ops.gather(x, k_fps.furthest_point_sample(x, m)).contiguous()
    assert torch.equal(k_bq.ball_query(c, x, r, 32),
                       k_bq.ball_query_plain(c, x, r, 32))


@pytest.mark.parametrize("n", [4, 20, 31, 33])
def test_ball_query_fewer_points_than_slots(dev, n):
    """N < U (and just above a warp): hits, then the first hit repeated;
    a centre with no hit gets 0; the lattice at r = 1.0 keeps the face
    neighbours (d2 = r2) out."""
    x = _cloud(dev, 2, n, 3, seed=n) * 0.3
    c = torch.cat([x[:, :3], torch.full((2, 1, 3), 50.0, device=dev)],
                  1).contiguous()
    got = k_bq.ball_query(c, x, 0.4, 32)
    assert torch.equal(got, k_bq.ball_query_plain(c, x, 0.4, 32))
    assert not got[:, -1].any()
    lat = _tie_cloud(dev, "lattice", 256)
    assert torch.equal(k_bq.ball_query(lat[:, :n].contiguous(), lat, 1.0, 32),
                       k_bq.ball_query_plain(lat[:, :n], lat, 1.0, 32))


@pytest.mark.parametrize("n,m,c", [(1024, 256, 256), (4096, 1024, 128)])
def test_interp_mm_gradient_at_path_shapes(dev, n, m, c):
    """The blend's backward through the scatter-sum kernel at the two FP
    stages that take it, against the plain blend under autograd."""
    x = _cloud(dev, 8, n, 3, seed=13)
    idx, w = k_tnn.three_nn(x, _cloud(dev, 8, m, 3, seed=14))
    f = _cloud(dev, 8, m, c, seed=15).to(torch.bfloat16).requires_grad_()
    cot = _cloud(dev, 8, n, c, seed=16)
    kernels.reset_counts()
    (k_interp.interp_mm(idx, w, f).float() * cot).sum().backward()
    got = f.grad.clone()
    assert kernels.counts()["scatter_sum"] == (1, 0)
    f.grad = None
    (k_interp.interp_mm_plain(idx, w, f).float() * cot).sum().backward()
    assert got.dtype == torch.bfloat16 and _rel(got, f.grad) < 1e-2


@pytest.mark.parametrize("kind", ["lattice", "duplicates"])
@pytest.mark.parametrize("n,m", LEVELS, ids=lambda v: str(v))
def test_fps_ties_at_every_level(dev, kind, n, m):
    x = _tie_cloud(dev, kind, n)
    assert torch.equal(k_fps.furthest_point_sample(x, m),
                       k_fps.furthest_point_sample_plain(x, m))


@pytest.mark.parametrize("n,m", [(96, 96), (1000, 300), (64, 64),
                                 (2048, 1024)], ids=lambda v: str(v))
def test_fps_odd_sizes(dev, n, m):
    """N that is no multiple of the block or of 32, M = N; the source's
    block size is the wrapper's rule."""
    for x in (_cloud(dev, 3, n, 3, seed=n), _tie_cloud(dev, "lattice", n)):
        assert torch.equal(k_fps.furthest_point_sample(x, m),
                           k_fps.furthest_point_sample_plain(x, m))
    assert _lib.library().bdm_fps_threads(n) == k_fps.threads(n)


@pytest.mark.parametrize("layout", ["one-voxel", "distinct"])
@pytest.mark.parametrize("divide", [True, False], ids=["mean", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 3, 7, 390, 512])
def test_scatter_mean_extremes(dev, c, dtype, divide, layout):
    """All points in one voxel (a long run, every other voxel empty) or
    each in its own; equal to the CPU's plain version bit for bit."""
    if layout == "one-voxel":
        ctx = ops.make_voxel_context(torch.full((2, 300, 3), 0.25,
                                                device=dev), 8,
                                     normalize=False)
        r = 8
    else:
        g = torch.stack(torch.meshgrid(*[torch.arange(8.0)] * 3,
                                       indexing="ij"), -1).reshape(-1, 3)
        perm = torch.randperm(512, generator=torch.Generator().manual_seed(c))
        ctx = ops.make_voxel_context(g[perm].expand(2, 512, 3).to(dev), 16)
        r = 16
    counts = ctx.voxel_lo[:, 1:] - ctx.voxel_lo[:, :-1]
    assert counts.max() == (300 if layout == "one-voxel" else 1)
    n = ctx.order.shape[1]
    f = _cloud(dev, 2, n, c, seed=c).to(dtype)
    args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, r, dtype, divide)
    got = k_vox.scatter_mean(*args, ids=ctx.ids)
    want = k_vox.scatter_mean_plain(
        *(t.cpu() if torch.is_tensor(t) else t for t in args))
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    code = _lib.DTYPE_CODES[dtype]
    lib = _lib.library()
    assert (lib.bdm_scatter_mean_vec(code, code, c),
            lib.bdm_scatter_mean_lanes(code, code, c)) == \
        k_vox.kernel_path(dtype, dtype, c)


def test_scatter_mean_refuses_misaligned_features(dev):
    """A view that starts off the vector's alignment raises instead of
    reading across it."""
    x = _cloud(dev, 2, 100, 3, seed=1)
    ctx = ops.make_voxel_context(x, 8)
    flat = torch.zeros(2 * 100 * 64 + 1, dtype=torch.bfloat16, device=dev)
    f = flat[1:].view(2, 100, 64)
    with pytest.raises(ValueError):
        k_vox.scatter_mean(f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 8,
                           torch.bfloat16, ids=ctx.ids)
    # the scatter-sum reads its rows in the same vectors
    with pytest.raises(ValueError):
        k_ss.scatter_sum(f, ctx.ids, 8)


@pytest.mark.parametrize("s,c", chip_smoke.ATTNS, ids=lambda v: str(v))
def test_float32_attention_at_path_shapes(dev, s, c):
    q, k, v = (_cloud(dev, 2, s, c, seed=50 + i) * 0.3 for i in range(3))
    kernels.reset_counts()
    out = k_attn.attention(q, k, v)
    assert kernels.path_counts()["attention"] == {"tc": 0, "simt": 1}
    assert _rel(out, k_attn.attention_plain(q, k, v)) < 1e-4


@pytest.mark.parametrize("cin,cout,r", chip_smoke.CONVS, ids=lambda v: str(v))
def test_float32_conv3d_at_path_shapes(dev, cin, cout, r):
    x = _cloud(dev, 2, r, r, r, cin, seed=60)
    wt = _cloud(dev, cout, cin, 3, 3, 3, seed=61) * (27 * cin) ** -0.5
    bias = _cloud(dev, cout, seed=62) * 0.1
    kernels.reset_counts()
    out = k_conv.conv3d(x, wt, bias)
    assert kernels.path_counts()["conv3d"] == {"tc": 0, "simt": 1}
    assert _rel(out, k_conv.conv3d_plain(x, wt, bias)) < 1e-4


@pytest.mark.parametrize("n,m", chip_smoke.FPS_LARGE, ids=lambda v: str(v))
def test_fps_past_the_registers(dev, n, m):
    """Clouds whose points a thread cannot hold in registers (K 16 at
    1,024 threads) take the streamed variant: the same indices."""
    x = _cloud(dev, 2, n, 3, seed=n)
    assert torch.equal(k_fps.furthest_point_sample(x, m),
                       k_fps.furthest_point_sample_plain(x, m))
    lib = _lib.library()
    assert (lib.bdm_fps_threads(n), lib.bdm_fps_points(n)) == (
        k_fps.threads(n), k_fps.points(n))
    assert k_fps.points(n) > k_fps.MAX_REGISTER_POINTS or n == 16384


def test_dropout_is_a_function_of_the_seed_on_the_card(dev):
    """A tiny float32 PC2 loss in training mode (dropout 0.1) with one
    draw of timesteps and noise: the masks of `TrainNoise` seed 1 give one
    loss twice, seed 2 another."""
    from bdm_tpu_torch.samplers import PC2Model, TrainNoise
    from bdm_tpu_torch.tools.standins import training_batches
    pc2 = PC2Model(chip_smoke.tiny_config(), chip_smoke.TINY_SA,
                   chip_smoke.TINY_FP, device=dev, dropout=0.1)
    pc2.reset_parameters(0)
    with torch.no_grad():      # a visible head: under PC2's 1e-6 one the
        head = pc2.backbone.classifier[2].weight    # masks barely show
        head.copy_(torch.randn(head.shape, generator=torch.Generator()
                               .manual_seed(5)).to(dev) * 0.1)
    batch = next(training_batches(1, 2, 64, dev, image_size=16))
    g = torch.Generator().manual_seed(3)
    draw = (torch.tensor([3, 700]), torch.randn(2, 64, 3, generator=g))
    pc2.train()
    with torch.no_grad():
        losses = [float(pc2.loss(batch, TrainNoise(seed, dev, replay=[draw])))
                  for seed in (1, 1, 2)]
    pc2.eval()
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0])
    assert losses[2] != losses[0]


@pytest.mark.parametrize("cin,cout,r", [(3, 7, 8), (390, 30, 8),
                                        (6, 130, 16), (1, 1, 8)],
                         ids=lambda v: str(v))
def test_float32_conv3d_halo_tiles(dev, cin, cout, r):
    """Grids whose R is a multiple of 8 take the float32 kernel's halo
    tiles: odd and even Cin (4- and 8-byte copies), Cout no multiple of 4
    or of the N tile; on a batch slice as on the whole."""
    whole = _cloud(dev, 3, r, r, r, cin, seed=70)
    wt = _cloud(dev, cout, cin, 3, 3, 3, seed=71) * (27 * cin) ** -0.5
    bias = _cloud(dev, cout, seed=72) * 0.1
    for x in (whole[:2], whole[1:]):
        out = k_conv.conv3d(x, wt, bias)
        assert out.shape == (2, r, r, r, cout)
        assert _rel(out, k_conv.conv3d_plain(x, wt, bias)) < 1e-4


def _hold_three_nn(x, c):
    i, w = k_tnn.three_nn(x, c)
    pi, pw = k_tnn.three_nn_plain(x, c)
    assert torch.equal(i, pi)
    assert _rel(w, pw) <= 1e-6


@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates"])
@pytest.mark.parametrize("n,m", LEVELS + [(2048, 1024)],
                         ids=lambda v: str(v))
def test_three_nn_at_every_level(dev, kind, n, m):
    """The FP levels of PC2 and the first of PVD at twice the width (B 8),
    centres by FPS, on random and tie-heavy clouds; the lattice also
    against the centres of its cells (eight corners at one distance). The
    source's split is the wrapper's rule."""
    x = (_cloud(dev, 8, n, 3, seed=n) * 0.3 if kind == "random"
         else _tie_cloud(dev, kind, n, b=8))
    c = ops.gather(x, k_fps.furthest_point_sample(x, m)).contiguous()
    _hold_three_nn(x, c)
    if kind == "lattice":
        _hold_three_nn(x + 0.5, c)
    lib = _lib.library()
    assert (lib.bdm_three_nn_lanes(8, n, m), lib.bdm_three_nn_step(m)) == (
        k_tnn.lanes(8, n, m), k_tnn.step(m))


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 17])
def test_three_nn_fewer_than_three_centres(dev, n, m):
    """M 1 and 2 repeat the last centre found, as the reference does; M 3,
    5 and 17 at N 64 leave lanes with no centre (M < L), and at N 4096 a
    single lane a query holds sentinels in its unused slots."""
    x = _cloud(dev, 8, n, 3, seed=m)
    c = _cloud(dev, 8, m, 3, seed=m + 100)
    if n == 64 and m > 2:
        assert k_tnn.lanes(8, n, m) > m
    _hold_three_nn(x, c)
    if m < 3:
        i, _ = k_tnn.three_nn(x, c)
        assert (i[..., 2] == i[..., m - 1]).all()


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scatter_mean_precontract_width(dev, in_dtype):
    """The precontracted stage-0 conv's tap scatter: C 864 (27 taps of 32
    outputs), float32 out, R 32, N 4096; equal to the CPU's plain version
    bit for bit, through `scatter_mean_contributions`."""
    x = _cloud(dev, 2, 4096, 3, seed=864) * 0.3
    ctx = ops.make_voxel_context(x, 32)
    f = _cloud(dev, 2, 4096, 864, seed=865).to(in_dtype)
    assert k_vox.kernel_path(in_dtype, torch.float32, 864) == (4, 32)
    got = ops.scatter_mean_contributions(f, ctx, 32)
    cpu = ops.VoxelContext(*(t.cpu() for t in ctx))
    want = ops.scatter_mean_contributions(f.cpu(), cpu, 32)
    assert got.dtype == torch.float32 and got.shape == (2, 32 ** 3, 864)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cin", [391, 392, 774, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_new_stage0_widths(dev, dtype, cin):
    """Stage 0's first conv at the widths of the options: mask (391), mask
    and distance transform (392), global ViT features (774), PVCNN2++
    (67); Cout 32, R 32, against the plain version."""
    x = _cloud(dev, 2, 32, 32, 32, cin, seed=cin).to(dtype)
    w = _cloud(dev, 32, cin, 3, 3, 3, seed=cin + 1) * (27 * cin) ** -0.5
    b = _cloud(dev, 32, seed=cin + 2) * 0.1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel(k_conv.conv3d(x, w, b), k_conv.conv3d_plain(x, w, b)) <= tol


def test_precontracted_denoise_on_the_card(dev):
    """One float32 PC2 denoise at production widths (ViT-S/16, 390 input
    channels), B 2, N 4096, through the precontracted stage-0 conv and
    through the plain one, both on the card: within 1e-4 of the largest
    output (a float32 sum over 390 channels taken in another order)."""
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    from bdm_tpu_torch.tools.standins import camera
    pc2 = PC2Model(ProjectionConfig(precontract=True))
    pc2.reset_parameters(0)
    with torch.no_grad():
        head = pc2.backbone.classifier[2].weight
        head.copy_(_cloud(dev, *head.shape, seed=5) * 0.1)
    g = torch.Generator().manual_seed(1)
    image = torch.rand(2, 224, 224, 3, generator=g).to(dev)
    x = (torch.randn(2, 4096, 3, generator=g) * 0.3).to(dev)
    t = torch.tensor([500, 20], device=dev)
    cam = camera(2, dev)
    with torch.inference_mode():
        raw = pc2.conditioning_map(image)
        pre = pc2.maybe_precontract(raw)
        kernels.reset_counts()
        got = pc2.denoise(x, t, cam, pre)
        want = pc2.denoise(x, t, cam, pc2.prepare_cond(raw))
    assert kernels.counts()["scatter_mean"][1] == 0
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_data_parallel_step_on_two_ranks(dev, tmp_path):
    """One data-parallel SGD step of the tiny PC2 (dropout 0.1) on two
    ranks spawned on the card (gloo when they share it, NCCL with a card
    each), a row a rank, against one process's step on both rows on the
    card: loss and gradient norm within 1e-5 relative, every parameter
    within 1e-5 of its tensor's largest entry over a floor of 1e-7 of the
    model's largest (a conv bias ahead of a GroupNorm holds rounding noise
    only); each rank launched the float32 path's kernels and ran no plain
    version on the card."""
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig, TrainNoise
    from bdm_tpu_torch.tools.standins import training_batches
    from bdm_tpu_torch.train import make_train_step
    # by its path: a spawned rank imports it by name, and `tests` may name
    # another package where this file runs without the JAX package
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks as R
    cfg = dict(image_size=16, image_feature_model="identity",
               raster_point_radius=0.3, point_cloud_model_embed_dim=8)
    pc2 = PC2Model(ProjectionConfig(**cfg), R.TINY_SA, R.TINY_FP,
                   device="cpu")
    pc2.reset_parameters(0)
    with torch.no_grad():
        head = pc2.backbone.classifier[2].weight
        head.copy_(torch.randn(head.shape) * 0.1)
    batch = next(training_batches(1, 2, 64, "cpu", image_size=16))
    cam = {k: getattr(batch["camera"], k)
           for k in ("R", "T", "focal_length", "principal_point")}
    inputs = {"cfg": cfg, "state": pc2.state_dict(),
              "batch": {"image": batch["image"], "points": batch["points"],
                        "camera": cam}}
    outs = R.run(R.cuda_dp_rank, 2, tmp_path, inputs)
    one = R.tiny_pc2(cfg, inputs["state"], 0.1, dev)
    want = make_train_step(one.loss)(
        R.sgd_state(one), R.batch_of({"batch": {
            k: ({n: t.to(dev) for n, t in v.items()} if k == "camera"
                else v.to(dev)) for k, v in inputs["batch"].items()}}),
        TrainNoise(7, dev))
    want_params = {k: v.cpu() for k, v in R.params(one).items()}
    floor = 1e-7 * max(float(w.abs().max()) for w in want_params.values())
    for out in outs:
        for k in ("loss", "grad_norm"):
            assert abs(out["metrics"][k] - float(want[k])) <= 1e-5 * abs(
                float(want[k])), (k, out["metrics"])
        for k, w in want_params.items():
            err = float((out["params"][k] - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()) + floor, (k, err)
        for name, (launches, plain) in out["counts"].items():
            assert plain == 0, name
            if name not in ("interp_mm", "scatter_sum", "attention"):
                assert launches > 0, name


# ---------------------------------------------------------- GroupNorm

def _gn_calls(net, *args):
    """(S, C, silu) of every GroupNormCL call of one forward."""
    from bdm_tpu_torch.models.layers import GroupNormCL
    calls = []
    hooks = [m.register_forward_hook(
        lambda m, a, kw, o: calls.append(
            (a[0].numel() // (a[0].shape[0] * a[0].shape[-1]),
             a[0].shape[-1], kw.get("silu", False))), with_kwargs=True)
        for m in net.modules() if isinstance(m, GroupNormCL)]
    with torch.inference_mode():
        net(*args)
    for h in hooks:
        h.remove()
    return calls


@pytest.fixture(scope="module")
def gn_sites():
    """The (S, C) a bf16 PC2 (387 extra channels) and PVD forward hand
    GroupNorm at B 2, N 4096, collected by forward hooks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from bdm_tpu_torch.models.pvcnn import PVCNN2
    dev = torch.device("cuda")
    sites = set()
    for extra in (387, 0):
        net = PVCNN2(extra_feature_channels=extra,
                     dtype=torch.bfloat16).to(dev)
        net.reset_parameters(0)
        x = _cloud(dev, 2, 4096, 3 + extra, seed=extra) * 0.3
        sites |= {(s, c) for s, c, _ in _gn_calls(
            net, x, torch.tensor([500, 20], device=dev))}
    return sorted(sites)


def _gn_within_one_rounding(got, x, w, b, silu):
    """bf16 output within one bf16 rounding of the float32 form, each
    element (2^-8 of itself), over the last bits of the float32
    statistics (1e-5 of the largest value)."""
    ref = k_gn.group_norm_plain(x.float(), w, b, 8, 1e-5, torch.float32,
                                silu)
    err = (got.float() - ref).abs()
    return bool((err <= 2 ** -8 * ref.abs() + 1e-5 * ref.abs().max()).all())


@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm+silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_groupnorm_at_path_shapes(dev, gn_sites, dtype, silu):
    assert len(gn_sites) >= 10, gn_sites
    for k, (s, c) in enumerate(gn_sites):
        x = (_cloud(dev, 2, s, c, seed=k) * 1.7 + 0.4).to(dtype)
        w = _cloud(dev, c, seed=k + 100)
        b = _cloud(dev, c, seed=k + 200)
        kernels.reset_counts()
        got = k_gn.group_norm(x, w, b, 8, 1e-5, silu=silu)
        assert kernels.counts()["groupnorm"] == (2, 0)
        assert got.dtype == dtype and got.shape == x.shape
        want = k_gn.group_norm_plain(x, w, b, 8, 1e-5, dtype, silu)
        if dtype == torch.float32:
            assert _rel(got, want) <= 1e-5, (s, c)
        else:
            assert _gn_within_one_rounding(got, x, w, b, silu), (s, c)
            assert _rel(got, want) <= 1e-2, (s, c)


@pytest.mark.parametrize("s,c", [(1000, 24), (37, 40), (5, 512),
                                 (4097, 64), (100, 2048)], ids=str)
def test_groupnorm_ragged_shapes(dev, s, c):
    """A last chunk of one row, C no power of two (a 16-byte vector across
    groups), a row a block's pass, one chunk a sample."""
    x = (_cloud(dev, 3, s, c, seed=s) * 2.0).to(torch.bfloat16)
    w, b = _cloud(dev, c, seed=1), _cloud(dev, c, seed=2)
    got = k_gn.group_norm(x, w, b, 8, 1e-5, silu=True)
    assert _gn_within_one_rounding(got, x, w, b, True), (s, c)


def test_groupnorm_offset_far_above_the_spread(dev):
    """x = 1000 + N(0, 1) in float32: E[x^2] - mean^2 loses the variance
    (checked here on the same data); the kernel is within 1e-4 of a
    float64 evaluation (the float32 mean's own rounding, 3e-5 at 1000)."""
    x = 1000.0 + _cloud(dev, 4, 32768, 64, seed=3)
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    got = k_gn.group_norm(x, w, b, 8, 1e-5)
    want = k_gn.group_norm_plain(x.double(), w.double(), b.double(), 8, 1e-5,
                                 torch.float64)
    assert _rel(got, want) <= 1e-4
    xg = x.reshape(4, -1, 8, 8)
    naive = xg.square().mean((1, 3)) - xg.mean((1, 3)) ** 2
    assert (naive - xg.double().var((1, 3), unbiased=False)).abs().max() > 1e-2


def test_groupnorm_two_calls_bit_equal(dev):
    x = _cloud(dev, 8, 32768, 64, seed=4).to(torch.bfloat16)
    w, b = _cloud(dev, 64, seed=5), _cloud(dev, 64, seed=6)
    first = k_gn.group_norm(x, w, b, 8, 1e-5, silu=True)
    assert torch.equal(first, k_gn.group_norm(x, w, b, 8, 1e-5, silu=True))


def test_groupnorm_split_is_the_sources(dev):
    lib = _lib.library()
    for dt in (torch.float32, torch.bfloat16):
        for s in (0, 1, 16, 4097, 32768, 2 ** 25):
            for c in (8, 12, 24, 32, 64, 512, 1024, 2048, 4096):
                for g in (1, 8, 16, 33):
                    assert lib.bdm_groupnorm_chunks(
                        s, c, g, _lib.DTYPE_CODES[dt]) == k_gn.chunks(
                            s, c, g, dt), (s, c, g, dt)


def test_groupnorm_refuses(dev):
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    x = _cloud(dev, 2, 16, 64).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k_gn.group_norm(x.transpose(0, 1), w, b, 8, 1e-5)
    with pytest.raises(ValueError, match="not a shape"):
        k_gn.group_norm(x, w, b, 7, 1e-5)
    with pytest.raises(TypeError):
        k_gn.group_norm(x.half(), w, b, 8, 1e-5)
    with pytest.raises(TypeError, match="keep x's type"):
        k_gn.group_norm(x, w, b, 8, 1e-5, torch.float32)
    shifted = torch.empty(x.numel() + 4, dtype=x.dtype, device=dev)[4:]
    with pytest.raises(ValueError, match="aligned"):
        k_gn.group_norm(shifted.view(x.shape), w, b, 8, 1e-5)


def test_groupnorm_launches_in_a_bf16_pc2_forward(dev):
    """Every GroupNorm of a bf16 PC2 forward takes the kernel (two launches
    a call, 63 calls, no plain call), under autograd too."""
    from bdm_tpu_torch.models.pvcnn import PVCNN2
    net = PVCNN2(extra_feature_channels=387, dtype=torch.bfloat16).to(dev)
    net.reset_parameters(0)
    x = _cloud(dev, 2, 4096, 390, seed=7) * 0.3
    t = torch.tensor([500, 20], device=dev)
    kernels.reset_counts()
    calls = _gn_calls(net, x, t)
    assert len(calls) == 63 and sum(c[2] for c in calls) == 62
    assert kernels.counts()["groupnorm"] == (63 * k_gn.LAUNCHES_A_CALL, 0)
    kernels.reset_counts()
    net(x, t).sum().backward()
    assert kernels.counts()["groupnorm"] == (63 * k_gn.LAUNCHES_A_CALL, 0)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters()
               if p.requires_grad)


@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm+silu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
def test_groupnorm_backward_at_path_shapes(dev, gn_sites, dtype, tol, silu):
    """x's, the weight's and the bias's gradients through the kernel pair
    and its backward against PyTorch's autograd through the plain form on
    the card, within `tol` of each gradient's largest entry (float32: sums
    in another order; bf16: the plain form rounds the affine to bf16
    before its SiLU, the kernel after)."""
    for k, (s, c) in enumerate(gn_sites):
        x = (_cloud(dev, 2, s, c, seed=k) * 1.7 + 0.4).to(dtype)
        w = _cloud(dev, c, seed=k + 100) * 0.5 + 1
        b = _cloud(dev, c, seed=k + 200) * 0.5
        cot = _cloud(dev, 2, s, c, seed=k + 300)
        grads = []
        for fn in (k_gn.group_norm, k_gn.group_norm_plain):
            ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
            (fn(*ins, 8, 1e-5, silu=silu).float() * cot).sum().backward()
            grads.append([t.grad for t in ins])
        for got, want in zip(*grads):
            assert got.dtype == want.dtype, (s, c)
            assert _rel(got, want) <= tol, (s, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sharded_groupnorm_on_two_ranks(dev, tmp_path, dtype):
    """The point-sharded norm through the kernel pair on two ranks spawned
    on the card (a shard of 4,096 of 8,192 points each): every rank's
    statistics are the whole's, so its output rows are the unsharded
    kernel's (float32 within 1e-5 of the largest value, bf16 within one
    bf16 rounding of the float32 form), x's gradient rows within 1e-4 and
    the sum of the ranks' weight and bias gradients within 1e-4 of the
    unsharded ones (float32, bf16 1e-2); each rank launched the kernel
    twice a call and ran no plain form."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks as R
    c = 64
    g = torch.Generator().manual_seed(11)
    x = (torch.randn(2, 8192, c, generator=g) * 1.7 + 0.4).to(dtype)
    w = torch.randn(c, generator=g) * 0.5 + 1
    b = torch.randn(c, generator=g) * 0.5
    cot = torch.randn(2, 8192, c, generator=g)
    outs = R.run(R.cuda_gn_rank, 2, tmp_path,
                 {"x": x, "w": w, "b": b, "cot": cot})
    ins = [t.to(dev).requires_grad_(True) for t in (x, w, b)]
    want = k_gn.group_norm(*ins, 8, 1e-5, silu=True)
    (want.float() * cot.to(dev)).sum().backward()
    ref = k_gn.group_norm_plain(x.to(dev).float(), w.to(dev), b.to(dev), 8,
                                1e-5, torch.float32, True)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    half = 8192 // 2
    for r, o in enumerate(outs):
        rows = slice(r * half, (r + 1) * half)
        assert o["counts"] == (2 * k_gn.LAUNCHES_A_CALL, 0), o["counts"]
        assert o["again_equal"], r
        y = o["y"].to(dev)
        assert y.dtype == dtype, r
        if dtype == torch.float32:
            assert _rel(y, want[:, rows]) <= 1e-5, r
        else:
            err = (y.float() - ref[:, rows]).abs()
            lim = 2 ** -8 * ref[:, rows].abs() + 1e-5 * ref.abs().max()
            assert bool((err <= lim).all()), r
        assert _rel(o["dx"].to(dev), ins[0].grad[:, rows]) <= tol, r
    assert _rel(sum(o["dw"] for o in outs).to(dev), ins[1].grad) <= tol
    assert _rel(sum(o["db"] for o in outs).to(dev), ins[2].grad) <= tol
