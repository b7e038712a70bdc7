"""The arithmetic of the two tensor-core kernels of `bdm_tpu_torch`
(`csrc/attention.cu`, `csrc/conv3d.cu`), on the CPU at small sizes: what
surrounds the CUDA code and can be said in PyTorch.

  * the tiled online softmax of the attention kernel, emulated with its
    roundings (probabilities rounded to v's type for the second product,
    the row sum taken over the unrounded float32 probabilities, float32
    output rescaled a tile, `exp2` of log2(e)-scaled logits), against the
    port's plain version and the Pallas kernel in interpret mode: float32
    1e-5 of the largest entry (the same sums in another order), bfloat16
    1e-2 (one bfloat16 rounding of sums that differ in their last bits);
  * the packed weight layout of the conv kernel: packed weights times the
    27 shifted views of a zero-padded grid equal the plain conv, and the
    padding is zero;
  * the cache of packed weights: refreshed after an in-place update and
    after `load_state_dict`, kept otherwise;
  * `kernel_path` at every shape `chip_smoke.py` holds on the card.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bdm_tpu.ops.pallas.attention import attention_pallas
from bdm_tpu_torch.models.pvcnn import VoxConv
from bdm_tpu_torch.ops.cuda import attention as k_attn, conv3d as k_conv

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOG2E = math.log2(math.e)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def attention_tiled(q, k, v, tile=64):
    """The tensor-core kernel's loop over key tiles, in PyTorch."""
    dt = v.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    b, s, c = q.shape
    out = torch.zeros(b, s, c)
    row_max = torch.full((b, s, 1), -math.inf)
    row_sum = torch.zeros(b, s, 1)
    for k0 in range(0, s, tile):
        logits = qf @ kf[:, k0:k0 + tile].transpose(1, 2)
        new_max = torch.maximum(row_max, logits.amax(-1, keepdim=True))
        scale = torch.exp2((row_max - new_max) * LOG2E)   # 0 at the first
        p = torch.exp2(logits * LOG2E - new_max * LOG2E)
        row_sum = row_sum * scale + p.sum(-1, keepdim=True)
        out = out * scale + p.to(dt).float() @ vf[:, k0:k0 + tile]
        row_max = new_max
    return (out * (1.0 / row_sum)).to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [16, 64])
@pytest.mark.parametrize("s", [64, 125])
def test_tiled_online_softmax(s, c, dtype):
    rng = np.random.default_rng(s + c)
    # a scale that gives peaked rows: the running maximum matters
    q, k, v = (torch.from_numpy(
        rng.standard_normal((2, s, c)).astype(np.float32) * 0.7).to(dtype)
        for _ in range(3))
    got = attention_tiled(q, k, v)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, k_attn.attention_plain(q, k, v)) < TOL[dtype]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = attention_pallas(*(jnp.asarray(t.float().numpy()).astype(jdt)
                                for t in (q, k, v)))
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    assert _rel(got, pallas) < TOL[dtype]


def test_tiled_softmax_first_tile_and_masked_keys():
    """exp2(-inf - m) of the first tile is 0, not NaN, and keys masked with
    -inf (the ragged last tile) add nothing."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 16))
                                .astype(np.float32)) for _ in range(3))
    whole = attention_tiled(q, k, v, tile=64)       # last tile: 6 keys
    one = attention_tiled(q, k, v, tile=128)        # one ragged tile
    assert torch.isfinite(whole).all()
    assert _rel(whole, one) < 1e-5


def _conv_by_taps(x, packed, bias_p, cout):
    """Packed weights times the 27 shifted views of the zero-padded grid,
    channels padded to Cin_p: the conv kernel's sum."""
    b, r, cin = x.shape[0], x.shape[1], x.shape[-1]
    cin_p = packed.shape[1]
    halo = F.pad(x.float(), (0, cin_p - cin, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(b, r, r, r, packed.shape[2])
    for tap in range(27):
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        view = halo[:, kd:kd + r, kh:kh + r, kw:kw + r]
        acc += view @ packed[tap].float()
    return (acc + bias_p)[..., :cout].to(x.dtype)


@pytest.mark.parametrize("cin,cout,r", [(3, 8, 5), (6, 32, 5), (32, 40, 5),
                                        (20, 70, 4)])
def test_packed_weights(cin, cout, r):
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((2, r, r, r, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3, 3))
                         .astype(np.float32)) * (27 * cin) ** -0.5
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    packed = k_conv.pack_weight(w)
    cin_p, cout_p = packed.shape[1:]
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert cin_p % 16 == 0 and 0 <= cin_p - cin < 16
    assert cout_p % k_conv.n_tile(cout) == 0 and cout_p - cout < 64
    assert not packed[:, cin:].any() and not packed[:, :, cout:].any()
    bias_p = k_conv.pack_bias(bias, cout_p)
    assert bias_p.dtype == torch.float32 and not bias_p[cout:].any()
    got = _conv_by_taps(x, packed, bias_p, cout)
    assert _rel(got, k_conv.conv3d_plain(x, w, bias)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("how", ["add_", "load_state_dict"])
def test_packed_cache_follows_the_parameter(how):
    conv = VoxConv(6, 8)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    args = (conv.weight, conv.bias, torch.bfloat16)
    before = k_conv.packs
    w0, b0 = k_conv.packed(*args)
    w1, b1 = k_conv.packed(*args)
    assert w1 is w0 and b1 is b0 and k_conv.packs == before + 1
    # the float32 layout is a second entry of the same weight
    g0, _ = k_conv.packed(conv.weight, conv.bias, torch.float32)
    assert g0.shape == (27 * 6, 8) and k_conv.packed(*args)[0] is w0
    if how == "add_":
        with torch.no_grad():
            conv.weight.add_(1.0)
    else:
        state = {k: v + 1.0 for k, v in conv.state_dict().items()}
        conv.load_state_dict(state)
    w2, b2 = k_conv.packed(*args)
    assert w2 is not w0
    assert torch.equal(w2, k_conv.pack_weight(conv.weight))
    assert torch.equal(b2[:8], conv.bias.detach())
    assert k_conv.packed(*args)[0] is w2


def test_packed_cache_through_the_autograd_function():
    """`Function.apply` hands `forward` the parameter itself, so the cache
    hits from one call to the next; another tensor of the same shape
    misses."""
    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, bias):
            return x + k_conv.packed(weight, bias,
                                     torch.bfloat16)[0].sum()

        @staticmethod
        def backward(ctx, g):
            return g, None, None

    conv = VoxConv(3, 4)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.zero_()
    x = torch.zeros(2, requires_grad=True)
    before = k_conv.packs
    for _ in range(3):
        Probe.apply(x, conv.weight, conv.bias)
    with torch.inference_mode():
        Probe.apply(x, conv.weight, conv.bias)
    assert k_conv.packs == before + 1
    other = torch.nn.Parameter(torch.zeros_like(conv.weight))
    Probe.apply(x, other, conv.bias)
    assert k_conv.packs == before + 2


@pytest.mark.parametrize("cin,cout,r", chip_smoke.CONVS)
def test_conv_kernel_path(cin, cout, r):
    assert k_conv.kernel_path(torch.bfloat16, cin, cout, r) == "tc"
    assert k_conv.kernel_path(torch.float32, cin, cout, r) == "simt"


@pytest.mark.parametrize("s,c", chip_smoke.ATTNS + [(729, 16), (64, 8)])
def test_attention_kernel_path(s, c):
    assert k_attn.kernel_path(torch.bfloat16, s, c) == "tc"
    assert k_attn.kernel_path(torch.float32, s, c) == "simt"


def test_attention_kernel_path_odd_width():
    assert k_attn.kernel_path(torch.bfloat16, 200, 12) == "simt"
