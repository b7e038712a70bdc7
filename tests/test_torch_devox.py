"""The gated devoxelization on the CPU (`bdm_tpu_torch.ops.cuda.devox`,
`models.pvcnn.PVConv`): the plain form against the composition it replaces
(the trilinear sample as it stood, cast, times the cast gate, plus the cast
point branch), bit for bit at float32 and bf16; the corner rule; the
backward of the kernel's autograd function against autograd through the
composition; the rule that picks the kernel or the plain form; the
widths the kernel refuses; a PVConv through the new call and the
point-sharded devoxelization, with the parent's outputs bit for bit. The kernel itself runs on the card only (`test_torch_kernels_cuda.py`);
`test_torch_ops.py::test_trilinear_devoxelize` holds the trilinear sample
to `bdm_tpu`."""

import pytest
import torch

from bdm_tpu_torch import ops
from bdm_tpu_torch.models.pvcnn import PVConv
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import devox
from bdm_tpu_torch.parallel import point_sharded as psh

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


def parent_devoxelize(grid, norm_coords):
    """`ops.trilinear_devoxelize` as it stood before the kernel: the corner
    ids and weights computed inside the loop."""
    b, r = grid.shape[:2]
    c = grid.shape[-1]
    n = norm_coords.shape[1]
    lo_f = torch.floor(norm_coords)
    frac = norm_coords - lo_f
    lo = lo_f.long()
    step = (frac > 0).long()
    flat = grid.reshape(b, r ** 3, c)
    strides = (r * r, r, 1)
    base = lo[..., 0] * strides[0] + lo[..., 1] * strides[1] + lo[..., 2]
    out = torch.zeros((b, n, c), dtype=torch.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = (base + dx * step[..., 0] * strides[0]
                       + dy * step[..., 1] * strides[1]
                       + dz * step[..., 2] * strides[2])
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                vals = torch.gather(flat, 1, idx[..., None].expand(b, n, c))
                out = out + w[..., None] * vals.float()
    return out


def composition(grid, norm_coords, gate, pf):
    dt = grid.dtype
    vox = parent_devoxelize(grid, norm_coords).to(dt)
    return vox * gate[:, None, :].to(dt) + pf.to(dt)


def _coords(b, n, r, seed):
    """Voxel coordinates in [0, R-1]: uniform, whole numbers, R - 1 on an
    axis, and a hair below a whole number."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, n, 3), generator=g) * (r - 1)
    q = n // 4
    x[:, :q] = torch.floor(x[:, :q])
    x[:, q:2 * q, 0] = r - 1
    x[:, 2 * q:3 * q] = torch.nextafter(torch.ceil(x[:, 2 * q:3 * q]),
                                        torch.zeros(()))
    return x.clamp(0.0, r - 1)


def _inputs(b, n, r, c, dtype, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed + 1)
    grid = torch.randn((b, r, r, r, c), generator=g).to(dtype)
    gate = torch.rand((b, c), generator=g)
    pf = (torch.randn((b, n, c), generator=g) * 0.5).to(dtype)
    if grad:
        for t in (grid, gate, pf):
            t.requires_grad_(True)
    return grid, _coords(b, n, r, seed), gate, pf


@pytest.mark.parametrize("shape", [(2, 64, 4, 16), (3, 37, 5, 12)], ids=str)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_form_is_the_composition_bit_for_bit(shape, dtype):
    """B, N, R, C: C 16 takes the kernel's 16-byte path at both types, C 12
    the one-channel path in bf16."""
    args = _inputs(*shape, dtype)
    want = composition(*args)
    for got in (devox.gated_devoxelize_plain(*args),
                ops.gated_devoxelize(*args)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ops.trilinear_devoxelize(*args[:2]),
                       parent_devoxelize(*args[:2]))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_corner_rule_whole_coordinates_pick_one_voxel(dtype):
    """A whole-numbered coordinate, R - 1 included, samples its voxel alone
    (its upper corner is itself, at weight 0); every corner id lies in the
    grid, and the weights of a point sum to 1."""
    b, n, r, c = 2, 50, 4, 8
    grid, _, gate, pf = _inputs(b, n, r, c, dtype)
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, r, (b, n, 3), generator=g).float()
    x[:, :5] = r - 1
    ids, ws = devox.corners(x, r)
    assert ids.min() >= 0 and ids.max() < r ** 3
    assert torch.allclose(ws.sum(-1), torch.ones(b, n))
    vid = (x.long() * torch.tensor([r * r, r, 1])).sum(-1)
    want = torch.gather(grid.reshape(b, r ** 3, c), 1,
                        vid[..., None].expand(b, n, c))
    assert torch.equal(ops.trilinear_devoxelize(grid, x), want.float())
    ones, zeros = torch.ones(b, c), torch.zeros(b, n, c, dtype=dtype)
    assert torch.equal(ops.gated_devoxelize(grid, x, ones, zeros), want)
    # a coordinate a hair below R - 1 takes R - 1 as its upper corner
    ids, _ = devox.corners(torch.full((1, 1, 3), r - 1.001), r)
    assert ids.max() == r ** 3 - 1


def _grads(fn, inputs, cot):
    for t in inputs:
        t.grad = None
    (fn(*inputs).float() * cot).sum().backward()
    return [inputs[i].grad.clone() for i in (0, 2, 3)]


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-5), (BF16, 1e-2)],
                         ids=["f32", "bf16"])
def test_backward_is_the_compositions_gradient(dtype, tol):
    """`_GatedDevox`'s backward (the corners' w * g rows scatter-summed
    into their voxels, then scaled by the gate or multiplied by the grid)
    against autograd through the composition: the grid's, the gate's and
    pf's gradients within `tol` of their largest entry (float32: sums in
    another order; bf16: the composition rounds its products and the
    corners' scatters to bf16, the function keeps float32 to the end).
    Every voxel holds several points' corners (N 200 on R 4)."""
    b, n, r, c = 2, 200, 4, 16
    inputs = list(_inputs(b, n, r, c, dtype, seed=4, grad=True))
    cot = torch.randn((b, n, c), generator=torch.Generator().manual_seed(5))
    got = _grads(devox._GatedDevox.apply, inputs, cot)
    want = _grads(composition, inputs, cot)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        err = (a.float() - w.float()).abs().max() / w.float().abs().max()
        assert err < tol, (i, err)


def test_backward_takes_only_the_gradients_asked_for():
    """A frozen gate gives the grid's and pf's gradients only; a float32
    pf beside a bf16 grid gets a float32 gradient."""
    grid, x, gate, pf = _inputs(2, 16, 4, 8, BF16, seed=6)
    grid.requires_grad_(True)
    pf = pf.float().requires_grad_(True)
    devox._GatedDevox.apply(grid, x, gate, pf).float().sum().backward()
    assert gate.grad is None
    assert grid.grad.dtype == BF16 and pf.grad.dtype == F32
    assert torch.equal(pf.grad, torch.ones_like(pf))


@pytest.mark.parametrize("device,grad,want", [
    ("cpu", False, "plain"), ("cpu", True, "plain"),
    ("meta", False, "kernel"), ("meta", True, "kernel+backward")])
def test_dispatch_rule(device, grad, want, monkeypatch):
    """A CPU tensor takes the plain form whatever autograd wants; a tensor
    off the CPU the kernel, under autograd through its autograd function.
    The kernel's own checks of shape and type follow (`_check`, the
    `cuda` tests)."""
    calls = []

    def kernel(grid, x, gate, pf):
        calls.append("kernel")
        return torch.empty_like(pf)

    def plain(grid, x, gate, pf):
        calls.append("plain")
        return pf.clone()

    monkeypatch.setattr(devox, "_forward", kernel)
    monkeypatch.setattr(devox, "gated_devoxelize_plain", plain)
    b, n, r, c = 2, 8, 4, 16
    grid = torch.zeros((b, r, r, r, c), dtype=BF16,
                       device=device).requires_grad_(grad)
    x = torch.zeros((b, n, 3), device=device)
    gate = torch.ones((b, c), device=device)
    pf = torch.zeros((b, n, c), dtype=BF16, device=device)
    y = devox.gated_devoxelize(grid, x, gate, pf)
    assert calls == [want.split("+")[0]]
    assert (y.grad_fn is not None
            and "_GatedDevox" in y.grad_fn.name()) is (want ==
                                                      "kernel+backward")


def test_source_split(monkeypatch):
    """The source takes 16 bytes of channels a thread (8 bf16, 4 float32)
    and nothing narrower: the wrapper refuses a C that is no multiple of
    16 bytes before the launch (`_check`; its CUDA-tensor checks stood in
    for)."""
    monkeypatch.setattr(devox._lib, "check", lambda *a: None)
    for dtype, c, ok in ((BF16, 8, True), (BF16, 256, True),
                         (BF16, 12, False), (BF16, 4, False),
                         (F32, 4, True), (F32, 12, True), (F32, 6, False)):
        args = _inputs(1, 8, 4, c, dtype)
        if ok:
            assert devox._check(*args) == (1, 8, 4, c)
        else:
            with pytest.raises(ValueError, match="16 bytes"):
                devox._check(*args)


def test_cpu_calls_count_nothing():
    before = kernels.counts()["devox"]
    ops.gated_devoxelize(*_inputs(1, 8, 4, 8, F32))
    assert kernels.counts()["devox"] == before


def parent_pvconv(m, features, ctx):
    """`PVConv.forward` as it stood before the call (no precontract, no
    `group`): devoxelize, cast, gate, then the point branch added."""
    vl, r = m.voxel_layers, m.resolution
    dt = m.dtype or torch.float32
    g = vl[0](ops.avg_voxelize(features, ctx, r, out_dtype=dt))
    g = vl[3](vl[1](g, dt, silu=True))
    g = vl[5](vl[4](g), dt, silu=not m.attention)
    gate = vl[7](g)
    vox = parent_devoxelize(g, ctx.norm_coords).to(dt)
    vox = vox * gate[:, None, :].to(dt)
    return vox + m.point_features(features).to(dt)


@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
def test_pvconv_is_the_parents_bit_for_bit(dtype, monkeypatch):
    """A PVConv's output through `ops.gated_devoxelize`, which it calls once
    with the grid, the context's coordinates, the gate and the point
    branch, is the parent's composition bit for bit."""
    torch.manual_seed(7)
    m = PVConv(8, 16, 4, attention=False, dtype=dtype).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape) * 0.3)
    g = torch.Generator().manual_seed(8)
    pts = torch.randn((2, 40, 3), generator=g)
    feats = torch.randn((2, 40, 8), generator=g)
    ctx = ops.make_voxel_context(pts, 4)
    calls = []
    inner = ops.gated_devoxelize
    monkeypatch.setattr(ops, "gated_devoxelize",
                        lambda *a: calls.append(a) or inner(*a))
    with torch.no_grad():
        got = m(feats, ctx)
        want = parent_pvconv(m, feats, ctx)
    assert torch.equal(got, want)
    (grid, x, gate, pf), = calls
    assert x is ctx.norm_coords and grid.shape == (2, 4, 4, 4, 16)
    assert gate.shape == (2, 16) and pf.shape == (2, 40, 16)


def test_point_sharded_devoxelization_takes_the_call(monkeypatch):
    """`devoxelize_point_sharded`, the helper the point-sharded parity tests
    hold to `bdm_tpu`, takes the plain trilinear sample and no gated call:
    float32, the parent's bit for bit (a sharded PVConv calls
    `ops.gated_devoxelize` itself with its gate and point branch)."""
    grid, x, _, _ = _inputs(2, 30, 4, 8, BF16, seed=9)
    calls = []
    monkeypatch.setattr(ops, "gated_devoxelize",
                        lambda *a: calls.append(a))
    got = psh.devoxelize_point_sharded(grid, x)
    assert got.dtype == F32 and not calls
    assert torch.equal(got, parent_devoxelize(grid, x))
