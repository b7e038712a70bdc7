"""GroupNorm + SiLU on the CPU (`bdm_tpu_torch.ops.cuda.groupnorm`,
`models.layers.GroupNormCL`): the plain form against the norm and the
separate Swish it replaces, bit for bit; against `bdm_tpu`'s flax GroupNorm
at float32 (1e-5 of the largest value: flax takes the variance as
E[x^2] - mean^2, the port as the mean of squared deviations); the rule that
picks the kernel or the plain form, and that `GroupNormCL` leaves it to
`ops.group_norm`; the backward of the kernel pair's autograd function
against autograd through the plain form, with the kernels stood in for by
their arithmetic; the source's split, mirrored in Python; and the
call sites of a tiny PVCNN2, which pass `silu=True` exactly where a Swish
followed the norm, with the parent's outputs bit for bit. The kernel pair
itself runs on the card only (`test_torch_kernels_cuda.py`)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_tpu.models import layers as jax_layers
from bdm_tpu_torch import ops
from bdm_tpu_torch.models import layers
from bdm_tpu_torch.models.fusion import PVCNNFuse
from bdm_tpu_torch.models.layers import Attention, GroupNormCL, SharedMLP
from bdm_tpu_torch.models.pvcnn import PVCNN2, PVConv
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import groupnorm as gn
from tests.torch_ranks import TINY_FP, TINY_SA

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


def parent_norm(x, weight, bias, groups, eps, dtype=None):
    """`GroupNormCL.forward` as it stood before the SiLU moved into it
    (no `group`): the statistics in float32, the mean and then the mean of
    squared deviations, the affine in float32, one cast."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight + bias
    return y.to(dtype or x.dtype)


def _affine(c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(c, generator=g), torch.randn(c, generator=g)


def _x(shape, dtype, seed=0, offset=0.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 1.7 + offset).to(dtype)


# (B, N, C) points, (B, M, U, C) grouped neighbours, (B, R, R, R, C) grids
SHAPES = [(2, 64, 32), (2, 16, 8, 16), (2, 4, 4, 4, 64), (3, 5, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm+silu"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_form_is_the_norm_then_swish_bit_for_bit(shape, silu, dtype):
    c = shape[-1]
    w, b = _affine(c, 1)
    x = _x(shape, dtype, offset=0.3)
    want = parent_norm(x, w, b, 8, layers.GN_EPS)
    if silu:
        want = layers.swish(want)
    got = gn.group_norm_plain(x, w, b, 8, layers.GN_EPS, silu=silu)
    assert got.dtype == dtype and torch.equal(got, want)
    norm = GroupNormCL(8, c)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        assert torch.equal(norm(x, dtype, silu=silu), want)
        # the kernel pair's CPU entry is the plain form
        assert torch.equal(
            gn.group_norm(x, w, b, 8, layers.GN_EPS, silu=silu), want)


@pytest.mark.parametrize("out", [F32, BF16], ids=["to-f32", "to-bf16"])
def test_plain_form_casts_once_to_the_asked_type(out):
    """A float32 input cast to bf16 at the norm: one cast of the float32
    affine, then the Swish in bf16, as before."""
    x = _x((2, 32, 16), F32)
    w, b = _affine(16, 2)
    got = gn.group_norm_plain(x, w, b, 8, layers.GN_EPS, out, silu=True)
    assert torch.equal(got, F.silu(parent_norm(x, w, b, 8, layers.GN_EPS,
                                               out)))


@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm+silu"])
@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 4, 4, 4, 64)], ids=str)
def test_plain_form_matches_bdm_tpu_group_norm(shape, silu):
    """flax's `nn.GroupNorm` as `bdm_tpu/models/layers.py` builds it, and
    its `swish`, at float32."""
    c = shape[-1]
    w, b = _affine(c, 3)
    x = _x(shape, F32, seed=4, offset=0.5)
    mod = fnn.GroupNorm(num_groups=8, epsilon=jax_layers.GN_EPS)
    params = {"params": {"scale": jnp.asarray(w.numpy()),
                         "bias": jnp.asarray(b.numpy())}}
    want = mod.apply(params, jnp.asarray(x.numpy()))
    if silu:
        want = jax_layers.swish(want)
    want = torch.from_numpy(np.array(jax.device_get(want)))
    got = gn.group_norm_plain(x, w, b, 8, layers.GN_EPS, silu=silu)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


# (device, in dtype, out dtype, C, groups, group, grad) -> the form: a
# meta tensor stands for a card's, which the rule cannot tell apart (it
# asks only whether the tensor is on the CPU); "refused" raises TypeError
META, CPU = "meta", "cpu"
RULES = [
    ((META, BF16, BF16, 64, 8, None, False), "kernel"),
    ((META, F32, F32, 512, 8, None, False), "kernel"),
    ((META, BF16, BF16, 2048, 8, None, False), "kernel"),
    ((META, BF16, None, 32, 8, None, False), "kernel"),
    ((CPU, BF16, BF16, 64, 8, None, False), "plain"),
    ((META, BF16, BF16, 64, 8, None, True), "kernel+backward"),
    ((META, BF16, BF16, 64, 8, "a process group", False), "kernel"),
    ((META, F32, F32, 64, 8, "a process group", True), "kernel+backward"),
    ((CPU, F32, F32, 12, 4, None, False), "plain"),
    ((CPU, BF16, BF16, 64, 8, None, True), "plain"),
    ((CPU, F32, F32, 64, 8, "a process group", True), "plain"),
    ((CPU, F32, BF16, 64, 8, None, False), "plain"),
    ((CPU, torch.float16, torch.float16, 64, 8, None, False), "plain"),
    ((META, F32, BF16, 64, 8, None, False), "refused"),
    ((META, BF16, F32, 64, 8, None, False), "refused"),
    ((META, BF16, F32, 64, 8, None, True), "refused"),
]


@pytest.mark.parametrize("args,want", RULES,
                         ids=[str(i) for i in range(len(RULES))])
def test_dispatch_rule(args, want, monkeypatch):
    """A CPU tensor takes the plain form, whatever else the call asks; a
    tensor off the CPU takes the kernel pair, under autograd through its
    autograd function and with `group` handed on, or raises where the call
    asks for a type change the kernels do not make. The kernel's own
    checks of shape and type follow (`_check`, the `cuda` tests)."""
    device, dt, out, c, groups, group, grad = args
    calls = []

    def kernel(x, w, b, groups_, eps, silu, group_, keep_stats):
        calls.append(("kernel", groups_, group_, keep_stats))
        return x.clone(), None

    def plain(x, w, b, groups_, eps, dtype=None, silu=False, group_=None):
        calls.append(("plain", groups_, group_))
        return x.to(dtype or x.dtype)

    monkeypatch.setattr(gn, "_forward", kernel)
    monkeypatch.setattr(gn, "group_norm_plain", plain)
    x = torch.zeros((2, 8, c), dtype=dt, device=device).requires_grad_(grad)
    w = torch.ones(c, device=device)
    b = torch.zeros(c, device=device)
    if want == "refused":
        with pytest.raises(TypeError):
            gn.group_norm(x, w, b, groups, 1e-5, out, True, group)
        assert calls == []
        return
    y = gn.group_norm(x, w, b, groups, 1e-5, out, True, group)
    if want == "plain":
        assert calls == [("plain", groups, group)]
    else:
        assert calls == [("kernel", groups, group, grad)]
        assert (y.grad_fn is not None
                and "_GroupNorm" in y.grad_fn.name()) is grad


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference",
                                  "frozen"])
def test_group_norm_cl_asks_the_rule_with_what_it_sees(mode, monkeypatch):
    """`GroupNormCL` hands `ops.group_norm` the tensor, its own parameters,
    groups and eps, and the call's type, SiLU and `group`, whatever
    autograd wants: the choice of form is the op's."""
    norm = GroupNormCL(8, 16)
    x = _x((2, 8, 16), BF16)
    called = []
    monkeypatch.setattr(ops, "group_norm",
                        lambda *a: called.append(a) or a[0])
    if mode == "frozen":
        norm.requires_grad_(False)
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode,
           "frozen": torch.enable_grad}[mode]
    with ctx():
        norm(x, BF16, "a process group", silu=True)
    (xa, w, b, groups, eps, dt, silu, group), = called
    assert xa is x and w is norm.weight and b is norm.bias
    assert (groups, eps, dt, silu, group) == (8, layers.GN_EPS, BF16, True,
                                              "a process group")


def _as_the_kernels(x, weight, bias, groups, eps, silu, group, keep_stats):
    """The kernel pair's arithmetic on the CPU: the float32 statistics, the
    float32 affine, SiLU before the one rounding; the (mean, rstd) it
    used."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=(1, 3), keepdim=True)
                       + eps)
    y = ((xf - mean) * rstd).reshape(x.shape) * weight + bias
    y = F.silu(y) if silu else y
    stats = torch.stack([mean.reshape(b, groups), rstd.reshape(b, groups)],
                        -1)
    return y.to(x.dtype), stats if keep_stats else None


@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm+silu"])
@pytest.mark.parametrize("shape", [(2, 64, 32), (3, 4, 4, 4, 64),
                                   (2, 5, 24)], ids=str)
def test_backward_is_the_plain_forms_gradient(shape, silu, monkeypatch):
    """`_GroupNorm`'s backward, from the statistics the apply kernel
    keeps, against PyTorch's autograd through the plain form at float32:
    x's, the weight's and the bias's gradients within 1e-5 of their
    largest entry. The kernels are stood in for by their arithmetic."""
    monkeypatch.setattr(gn, "_forward", _as_the_kernels)
    c = shape[-1]
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(shape, generator=g) * 1.7 + 0.3).requires_grad_(True)
    w = (1 + 0.3 * torch.randn(c, generator=g)).requires_grad_(True)
    b = (0.2 * torch.randn(c, generator=g)).requires_grad_(True)
    cot = torch.randn(shape, generator=g)
    grads = []
    for fn in (lambda: gn._GroupNorm.apply(x, w, b, 8, layers.GN_EPS, silu,
                                           None),
               lambda: gn.group_norm_plain(x, w, b, 8, layers.GN_EPS,
                                           silu=silu)):
        for t in (x, w, b):
            t.grad = None
        (fn() * cot).sum().backward()
        grads.append([t.grad.clone() for t in (x, w, b)])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = (got - want).abs().max() / want.abs().max()
        assert err < 1e-5, err


def test_backward_takes_only_the_gradients_asked_for(monkeypatch):
    """A frozen norm (its weight and bias need no gradient) gives x's only;
    a bf16 x gets a bf16 gradient, the float32 parameters float32 ones."""
    monkeypatch.setattr(gn, "_forward", _as_the_kernels)
    x = _x((2, 16, 16), BF16).requires_grad_(True)
    w, b = torch.ones(16), torch.zeros(16)
    gn._GroupNorm.apply(x, w, b, 8, layers.GN_EPS, True, None).float() \
        .sum().backward()
    assert x.grad.dtype == BF16 and w.grad is None and b.grad is None
    w.requires_grad_(True)
    x.grad = None
    gn._GroupNorm.apply(x, w, b, 8, layers.GN_EPS, True, None).float() \
        .sum().backward()
    assert w.grad.dtype == F32 and b.grad is None and x.grad.dtype == BF16


def test_cpu_calls_count_nothing():
    before = kernels.counts()["groupnorm"]
    GroupNormCL(8, 16)(_x((2, 8, 16), F32), silu=True)
    assert kernels.counts()["groupnorm"] == before


@pytest.mark.parametrize("s,c,dtype,want", [
    (32768, 64, BF16, 64),      # 8 vectors a row, 32 rows a pass, 512 a chunk
    (32768, 32, BF16, 32),
    (32768, 64, F32, 128),
    (16, 512, BF16, 1),
    (4097, 64, BF16, 9),        # a last chunk of one row
    (100, 2048, BF16, 7),       # one row a pass, 16 rows a chunk
    (100, 4096, BF16, 0),       # a row past a block's pass
    (0, 64, BF16, 0),
    (2 ** 25, 64, BF16, 0),     # S C past 32-bit offsets
])
def test_source_split(s, c, dtype, want):
    assert gn.chunks(s, c, 8, dtype) == want


def _tiny(dtype, fuse=False):
    if fuse:
        net = PVCNNFuse(out_channels=3, embed_dim=8,
                        extra_feature_channels=5, sa_blocks=TINY_SA,
                        fp_blocks=TINY_FP, dtype=dtype)
    else:
        net = PVCNN2(embed_dim=8, extra_feature_channels=5,
                     sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                     classifier_init_scale=None, dtype=dtype)
    net.reset_parameters(0)
    # non-trivial affines, so a norm applied twice or skipped shows
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, GroupNormCL):
                m.weight.copy_(1 + 0.3 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return net


def _sites(net):
    """norm -> (the call site it sits at, whether a Swish followed it in
    the parent), from the module tree: the parent kept an `nn.SiLU` beside
    each norm that a Swish followed (SharedMLP, PVConv's first norm and
    its second where no attention follows), and Attention ended with one."""
    out = {}
    for m in net.modules():
        if isinstance(m, SharedMLP):
            for i in range(1, len(m.layers), 3):
                assert isinstance(m.layers[i + 1], nn.SiLU)
                out[m.layers[i]] = ("SharedMLP", True)
        elif isinstance(m, PVConv):
            vl = m.voxel_layers
            out[vl[1]] = ("PVConv first", isinstance(vl[2], nn.SiLU))
            out[vl[5]] = ("PVConv second", isinstance(vl[6], nn.SiLU))
        elif isinstance(m, Attention):
            out[m.norm] = ("Attention", True)
    return out


@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
def test_call_sites_pass_silu_where_a_swish_followed(dtype, monkeypatch):
    """One forward of a tiny PVCNN2 (attention in one stage, the global
    attention): every norm is called with `silu` as the module tree says,
    its output is the parent's norm (and Swish) of its input bit for bit,
    every one of the four call sites runs, and the network's output equals
    the parent's: the same forward with the norm computed as the parent
    computed it and the Swish applied after it."""
    net = _tiny(dtype)
    sites = _sites(net)
    assert set(sites) == {m for m in net.modules()
                          if isinstance(m, GroupNormCL)}
    calls = []

    def hook(m, args, kwargs, out):
        calls.append((m, args, kwargs, out))

    for m in sites:
        m.register_forward_hook(hook, with_kwargs=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 8, generator=g) * 0.5
    t = torch.tensor([517, 3])
    with torch.no_grad():
        got = net(x, t)
    ran = set()
    for m, args, kwargs, out in calls:
        site, swish_after = sites[m]
        ran.add((site, swish_after))
        assert kwargs.get("silu", False) is swish_after, site
        xin = args[0]
        dt = args[1] if len(args) > 1 else kwargs.get("dtype")
        want = parent_norm(xin, m.weight, m.bias, m.num_groups, m.eps, dt)
        if swish_after:
            want = layers.swish(want)
        assert torch.equal(out, want), site
    assert ran == {("SharedMLP", True), ("PVConv first", True),
                   ("PVConv second", True), ("PVConv second", False),
                   ("Attention", True)}

    def as_the_parent(self, x, dtype=None, group=None, silu=False):
        y = parent_norm(x, self.weight, self.bias, self.num_groups,
                        self.eps, dtype)
        return layers.swish(y) if silu else y

    monkeypatch.setattr(GroupNormCL, "forward", as_the_parent)
    with torch.no_grad():
        assert torch.equal(net(x, t), got)


def test_fusion_network_norms_take_silu_as_the_tree_says():
    """The fusion network holds the same blocks: every norm of one forward
    is called with `silu` as its module tree says."""
    net = _tiny(None, fuse=True)
    sites = _sites(net)
    flags = []
    for m in sites:
        m.register_forward_hook(
            lambda m, a, kw, o: flags.append(
                (kw.get("silu", False), sites[m][1])), with_kwargs=True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 8, generator=g) * 0.5
    prior = torch.randn(2, 64, 3, generator=g) * 0.5
    with torch.no_grad():
        net(x, prior, torch.tensor([517, 3]))
    assert flags and all(a is b for a, b in flags)
