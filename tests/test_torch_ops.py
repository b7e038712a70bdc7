"""Point ops and kernel plain versions of `bdm_tpu_torch` against `bdm_tpu`.

Inputs come from numpy seeds and go through the JAX function (its CPU
dispatch, and the Pallas kernel in interpret mode where one exists) and
through the port. Tolerances:
  * FPS, ball query, three-NN indices: exact (the port evaluates distances
    in the reference's order), including tie and radius-boundary cases;
  * float results, port plain vs JAX plain at float32: 1e-5 relative
    (the two frameworks sum in different orders);
  * port plain vs Pallas interpret: 3e-2 relative and absolute, because
    the Pallas kernels contract in bfloat16 (the bench's per-kernel bound);
  * `interp_mm_plain` vs the Pallas `interp_mm` and vs the gather form:
    8e-3 of the largest output, one bfloat16 rounding (2^-8 = 3.9e-3, on
    the output and, against the gather form, on the weights).
  * the Pallas convs round their operands to bfloat16 even for float32
    grids (the MXU's precision), so every conv of the TPU table
    (`conv3d_pallas`, `conv3d_wg_pallas`, `conv3d_ms_pallas` with either
    tap form, `conv3d_mm_pallas` unpadded) is held at that bf16 bound; so
    are the one-hot scatters (`scatter_sum_sorted_pallas`,
    `scatter_sum_pallas`), whose masks multiply bfloat16 features;
  * gradients of the differentiable wrappers against `jax.grad` of the
    matching `custom_vjp` function: float32 1e-5 of the largest entry,
    bfloat16 at the bf16 bound, cotangent dtypes checked.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu import ops as jops
from bdm_tpu.ops.pallas.attention import _attention_pallas_fwd_only
from bdm_tpu.ops.pallas.ball_query import ball_query_pallas
from bdm_tpu.ops.pallas.attention import attention_pallas
from bdm_tpu.ops.pallas.conv3d import (conv3d_mm_pallas, conv3d_ms,
                                       conv3d_ms_pallas, conv3d_pallas,
                                       conv3d_wg_pallas)
from bdm_tpu.ops.pallas.fps import furthest_point_sample_pallas
from bdm_tpu.ops.pallas.interp_mm import interp_mm as jax_interp_mm
from bdm_tpu.ops.pallas.three_nn import three_nn_pallas
from bdm_tpu.ops.pallas.voxelize import (scatter_sum_pallas,
                                         scatter_sum_sorted_padded_pallas,
                                         scatter_sum_sorted_pallas)
from bdm_tpu.ops.voxelize import run_counts_sorted
from bdm_tpu_torch import ops
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import (attention as k_attn, ball_query as k_bq,
                                    conv3d as k_conv, fps as k_fps,
                                    groupnorm as k_gn, interp as k_interp,
                                    scatter_sum as k_ss, three_nn as k_tnn,
                                    voxelize as k_vox)

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_TOL = 3e-2
BF16_ROUNDING = 8e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _cloud(seed, b, n):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(
        np.float32)


def _lattice(b, n):
    """Integer lattice points: many exactly equal distances."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pts = np.concatenate([g] * (n // len(g) + 1))[:n].astype(np.float32)
    return np.broadcast_to(pts, (b, n, 3)).copy()


# ----------------------------------------------------------------- FPS

@pytest.mark.parametrize("case", ["random", "ties"])
def test_fps_exact(case):
    x = _cloud(0, 2, 256) if case == "random" else _lattice(2, 96)
    m = 32
    got = ops.furthest_point_sample(_t(x), m).numpy()
    want = np.asarray(jops.furthest_point_sample(jnp.asarray(x), m,
                                                 use_pallas=False))
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(x), m,
                                                     interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


# ---------------------------------------------------------- ball query

def test_ball_query_exact_random():
    x = _cloud(1, 2, 256) * 0.5
    c = x[:, :64]
    for r in (0.1, 0.4):
        got = ops.ball_query(_t(c), _t(x), r, 8).numpy()
        want = np.asarray(jops.ball_query(jnp.asarray(c), jnp.asarray(x), r,
                                          8, use_pallas=False))
        pallas = np.asarray(ball_query_pallas(jnp.asarray(c), jnp.asarray(x),
                                              r, 8, interpret=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)


def test_ball_query_radius_boundary():
    """A point at exactly float32(r) is out (strict <), one ulp inside is
    in; a centre with no hit gets 0 in every slot."""
    r = 0.2
    rf = np.float32(r)
    inside = np.nextafter(rf, np.float32(0))
    pts = np.zeros((1, 8, 3), np.float32)
    pts[0, :, 0] = [5.0, rf, inside, -rf, 5.0, -inside, 5.0, 5.0]
    centers = np.zeros((1, 2, 3), np.float32)
    centers[0, 1] = [100.0, 0.0, 0.0]              # no neighbour at all
    got = ops.ball_query(_t(centers), _t(pts), r, 4).numpy()
    want = np.asarray(jops.ball_query(jnp.asarray(centers), jnp.asarray(pts),
                                      r, 4, use_pallas=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [2, 5, 2, 2])
    np.testing.assert_array_equal(got[0, 1], [0, 0, 0, 0])


@pytest.mark.parametrize("n", [4, 20])
def test_ball_query_fewer_points_than_slots(n):
    """N < U: the hits in scan order, then the first hit repeated; a centre
    with no hit gets 0 in every slot, as the Pallas kernel gives them."""
    x = _cloud(2, 2, n) * 0.3
    far = np.full((2, 1, 3), 50.0, np.float32)        # no neighbour at all
    c = np.concatenate([x[:, :3], far], 1)
    got = ops.ball_query(_t(c), _t(x), 0.4, 32).numpy()
    pallas = np.asarray(ball_query_pallas(jnp.asarray(c), jnp.asarray(x),
                                          0.4, 32, interpret=True))
    assert got.shape == (2, 4, 32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got[:, -1], 0)
    if n == 4:
        np.testing.assert_array_equal(
            k_bq.ball_query_plain(_t(x[:1, :1] * 0), _t(x[:1] * 0), 0.1,
                                  8)[0, 0], [0, 1, 2, 3, 0, 0, 0, 0])


# ------------------------------------------------------------ three-NN

@pytest.mark.parametrize("case", ["random", "ties"])
def test_three_nn(case):
    if case == "random":
        pts, ctr = _cloud(2, 2, 128), _cloud(3, 2, 32)
    else:
        pts = _lattice(2, 64) + 0.5
        ctr = np.concatenate([_lattice(2, 32)] * 2, axis=1)  # duplicates
    idx, w = ops.three_nn(_t(pts), _t(ctr))
    jidx, jw = jops.three_nn(jnp.asarray(pts), jnp.asarray(ctr),
                             use_pallas=False)
    pidx, pw = three_nn_pallas(jnp.asarray(pts), jnp.asarray(ctr), True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    _close(w.numpy(), jw, F32_RTOL)
    _close(w.numpy(), pw, F32_RTOL)


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_fewer_than_three_centres(m):
    """M < 3: the centres found, then the last one repeated, as the JAX
    function gives them (its plain path: the Pallas kernel takes M >= 3)."""
    pts, ctr = _cloud(7, 2, 64), _cloud(8, 2, m)
    idx, w = ops.three_nn(_t(pts), _t(ctr))
    jidx, jw = jops.three_nn(jnp.asarray(pts), jnp.asarray(ctr),
                             use_pallas=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w.numpy(), jw, F32_RTOL)
    assert (idx[..., 2] == idx[..., m - 1]).all()


def test_three_nn_interpolate():
    pts, ctr = _cloud(4, 2, 128), _cloud(5, 2, 32)
    f = np.random.default_rng(6).standard_normal((2, 32, 12)).astype(
        np.float32)
    got = ops.three_nn_interpolate(_t(pts), _t(ctr), _t(f))
    want = jops.three_nn_interpolate(jnp.asarray(pts), jnp.asarray(ctr),
                                     jnp.asarray(f))
    _close(got.numpy(), want, F32_RTOL)


@pytest.mark.parametrize("n", [512, 192], ids=["N512", "N192"])
def test_interp_mm_plain(n):
    """The bf16 blend against the Pallas kernel (interpret mode off the
    TPU) and against the float32-weight gather form, M 128, C 32."""
    m, c = 128, 32
    pts, ctr = _cloud(20, 2, n), _cloud(21, 2, m)
    f = np.random.default_rng(22).standard_normal((2, m, c)).astype(
        np.float32)
    idx, w = ops.three_nn(_t(pts), _t(ctr))
    fb = _t(f).to(torch.bfloat16)
    got = k_interp.interp_mm_plain(idx, w, fb)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, c)
    pallas = jax_interp_mm(jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(f).astype(jnp.bfloat16))
    assert pallas.dtype == jnp.bfloat16
    _close(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)),
           BF16_ROUNDING)
    gather = ops.three_nn_interpolate(_t(pts), _t(ctr), fb, impl="gather")
    assert gather.dtype == torch.float32
    _close(got.float().numpy(), gather.numpy(), BF16_ROUNDING)
    # the dispatcher's "onehot" form is this function
    forced = ops.three_nn_interpolate(_t(pts), _t(ctr), fb, impl="onehot")
    assert torch.equal(forced, got)


@pytest.mark.parametrize("dtype,n,m,onehot", [
    (torch.bfloat16, 256, 128, True),
    (torch.bfloat16, 1024, 128, True),     # two query tiles of 512
    (torch.float32, 256, 128, False),      # float32 features
    (torch.bfloat16, 256, 64, False),      # M < 128
    (torch.bfloat16, 640, 128, False),     # N not a multiple of 512
], ids=["bf16", "bf16-N1024", "f32", "M64", "N640"])
def test_interpolate_dispatch(dtype, n, m, onehot):
    """The reference's rule on its accelerator, without the environment
    variable: the one-hot form returns bf16, the gather form float32."""
    pts, ctr = _t(_cloud(23, 1, n)), _t(_cloud(24, 1, m))
    f = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (1, m, 8)).astype(np.float32)).to(dtype)
    out = ops.three_nn_interpolate(pts, ctr, f)
    assert out.dtype == (torch.bfloat16 if onehot else torch.float32)
    want = ops.three_nn_interpolate(pts, ctr, f,
                                    impl="onehot" if onehot else "gather")
    assert torch.equal(out, want)
    with pytest.raises(ValueError):
        ops.three_nn_interpolate(pts, ctr, f, impl="mxu")
    if dtype == torch.float32:     # the bf16 blend takes no float32 features
        with pytest.raises(TypeError):
            ops.three_nn_interpolate(pts, ctr, f, impl="onehot")


# ---------------------------------------------------------- voxelize

def _vox_inputs(seed, r, c):
    x = _cloud(seed, 2, 256)
    f = np.random.default_rng(seed + 1).standard_normal((2, 256, c)).astype(
        np.float32)
    return x, f, ops.make_voxel_context(_t(x), r), \
        jops.make_voxel_context(jnp.asarray(x), r)


def test_voxel_context_matches():
    x, _, ctx, jctx = _vox_inputs(7, 8, 4)
    np.testing.assert_array_equal(ctx.ids.numpy(), np.asarray(jctx.ids))
    np.testing.assert_array_equal(ctx.order.numpy(), np.asarray(jctx.order))
    _close(ctx.norm_coords.numpy(), jctx.norm_coords, F32_RTOL)
    counts = np.diff(ctx.voxel_lo.numpy(), axis=1)
    per_point = np.take_along_axis(counts, ctx.ids_sorted.numpy(), axis=1)
    np.testing.assert_array_equal(per_point,
                                  np.asarray(run_counts_sorted(jctx)))


@pytest.mark.parametrize("c", [3, 40])
def test_scatter_mean(c):
    r = 4
    _, f, ctx, jctx = _vox_inputs(8, r, c)
    got = ops.avg_voxelize(_t(f), ctx, r).numpy()
    want = np.asarray(jops.avg_voxelize_ctx(jnp.asarray(f), jctx, r))
    _close(got, want, F32_RTOL)
    # the Pallas kernel takes the pre-divided contributions in sorted order
    fs = jnp.take_along_axis(jnp.asarray(f), jctx.order[..., None], axis=1)
    fm = fs / run_counts_sorted(jctx)[..., None]
    gp = scatter_sum_sorted_padded_pallas(fm, jctx.ids_sorted, jctx.tile_lo,
                                          r, jnp.float32)
    pallas = np.asarray(gp)[:, 1:r + 1].reshape(got.shape)
    _close(got, pallas, BF16_TOL)
    # bf16 output: one rounding of the f32 sum
    bf = ops.avg_voxelize(_t(f), ctx, r, torch.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(),
                                  _t(got).to(torch.bfloat16).float().numpy())


def test_trilinear_devoxelize():
    r = 4
    x, _, ctx, jctx = _vox_inputs(9, r, 5)
    grid = np.random.default_rng(10).standard_normal(
        (2, r, r, r, 6)).astype(np.float32)
    nc = ctx.norm_coords.numpy().copy()
    nc[:, :8] = np.round(nc[:, :8])          # frac == 0: lower corner only
    nc[:, 8:10] = r - 1                      # the clamped upper face
    got = ops.trilinear_devoxelize(_t(grid), _t(nc)).numpy()
    want = np.asarray(jops.trilinear_devoxelize(jnp.asarray(grid),
                                                jnp.asarray(nc)))
    _close(got, want, F32_RTOL)


# ---------------------------------------------------------------- conv

@pytest.mark.parametrize("cin,cout", [(6, 8), (40, 16)])
def test_conv3d(cin, cout):
    r, b = 4, 2
    rng = np.random.default_rng(cin)
    g = rng.standard_normal((b, r, r, r, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    w_torch = np.transpose(k, (4, 3, 0, 1, 2))        # (Cout, Cin, 3, 3, 3)
    got = ops.voxel_conv3d(_t(g), _t(w_torch), _t(bias)).numpy()
    dn = jax.lax.conv_dimension_numbers(g.shape, k.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(g), jnp.asarray(k), (1, 1, 1), "SAME",
        dimension_numbers=dn, precision=jax.lax.Precision.HIGHEST) + bias
    _close(got, want, F32_RTOL)
    gp = jnp.pad(jnp.asarray(g).reshape(b, r, r * r, cin).astype(
        jnp.bfloat16), ((0, 0), (1, 1), (0, 0), (0, 0)))
    for fn in (conv3d_ms_pallas, conv3d_mm_pallas):
        kw = dict(prepadded=True, interpret=True)
        out = fn(gp, jnp.asarray(k), jnp.asarray(bias), r, **kw)
        _close(got, np.asarray(out.astype(jnp.float32)), BF16_TOL)


# ----------------------------------------------------------- attention

def test_attention():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    got = k_attn.attention(_t(q), _t(k), _t(v)).numpy()
    logits = jnp.einsum("bic,bjc->bij", q, k,
                        precision=jax.lax.Precision.HIGHEST)
    want = jnp.einsum("bij,bjc->bic", jax.nn.softmax(logits, axis=-1), v,
                      precision=jax.lax.Precision.HIGHEST)
    _close(got, want, F32_RTOL)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    pallas = _attention_pallas_fwd_only(*bf, interpret=True)
    _close(got, np.asarray(pallas.astype(jnp.float32)), BF16_TOL)
    # the layer's small-site path and the kernel's plain version agree
    _close(ops.attention(_t(q), _t(k), _t(v)).numpy(), got, F32_RTOL)


# ------------------------------------- the other rows of the TPU table

@pytest.mark.parametrize("counts", [False, True],
                         ids=["predivided", "count_channel"])
def test_scatter_sorted_unpadded_pallas(counts):
    """`scatter_sum_sorted_pallas` (float32, unpadded) under its two
    callers: pre-divided contributions (`_avg_voxelize_ctx_fwd_impl`) equal
    the mean store, raw rows with a count channel (`_scatter_augmented`)
    the `divide=False` store."""
    r, c = 4, 5
    _, f, ctx, jctx = _vox_inputs(21, r, c)
    tile_v = r ** 3 // (jctx.tile_lo.shape[1] - 1)
    fs = jnp.take_along_axis(jnp.asarray(f), jctx.order[..., None], axis=1)
    args = (ctx.order, ctx.ids_sorted, ctx.voxel_lo, r, torch.float32)
    if counts:
        faug = jnp.concatenate([fs, jnp.ones(fs.shape[:2] + (1,))], axis=-1)
        want = np.asarray(scatter_sum_sorted_pallas(
            faug, jctx.ids_sorted, jctx.tile_lo, r ** 3, True, tile_v))
        got = k_vox.scatter_mean(_t(f), *args, divide=False,
                                 ids=ctx.ids).numpy()
        _close(got.reshape(2, r ** 3, c), want[..., :c], BF16_TOL)
        np.testing.assert_array_equal(          # counts are exact in bf16
            want[..., c], np.diff(ctx.voxel_lo.numpy(), axis=1))
        # and the raw sums are the means times the counts
        mean = k_vox.scatter_mean(_t(f), *args, ids=ctx.ids).numpy().reshape(
            2, -1, c)
        _close(got.reshape(2, r ** 3, c), mean * want[..., c:], F32_RTOL)
    else:
        fm = fs / run_counts_sorted(jctx)[..., None]
        want = np.asarray(scatter_sum_sorted_pallas(
            fm, jctx.ids_sorted, jctx.tile_lo, r ** 3, True, tile_v))
        got = k_vox.scatter_mean(_t(f), *args, ids=ctx.ids).numpy()
        _close(got.reshape(2, r ** 3, c), want, BF16_TOL)


@pytest.mark.parametrize("c,segs", [(5, 16), (40, 64)])
def test_scatter_sum_unsorted(c, segs):
    rng = np.random.default_rng(c)
    b, n = 2, 96
    f = rng.standard_normal((b, n, c)).astype(np.float32)
    ids = rng.integers(0, segs, (b, n)).astype(np.int32)
    ids[:, :8] = 3                    # a crowded segment; some stay empty
    got = k_ss.scatter_sum(_t(f), _t(ids), segs)
    assert got.dtype == torch.float32 and got.shape == (b, segs, c)
    flat = (ids + np.arange(b)[:, None] * segs).reshape(-1)
    want = jax.ops.segment_sum(jnp.asarray(f).reshape(b * n, c),
                               jnp.asarray(flat), num_segments=b * segs)
    _close(got.numpy().reshape(b * segs, c), want, F32_RTOL)
    pallas = scatter_sum_pallas(jnp.asarray(f), jnp.asarray(ids), segs,
                                interpret=True)
    _close(got.numpy(), pallas, BF16_TOL)
    # bf16 rows are read as they are and summed in float32
    bf = k_ss.scatter_sum(_t(f).to(torch.bfloat16), _t(ids), segs)
    _close(bf.numpy(), k_ss.scatter_sum(
        _t(f).to(torch.bfloat16).float(), _t(ids), segs).numpy(), 1e-6)


def test_scatter_sum_drops_out_of_range_ids():
    """ids -1 and S in both batch elements add to no segment, as the
    Pallas kernel's one-hot mask drops them (integer features: the sums
    are exact in any order and in bfloat16)."""
    ones = torch.ones(2, 4, 1)
    ids = torch.tensor([[0, 1, 2, 2], [0, 0, 1, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        k_ss.scatter_sum(ones, ids, 2)[..., 0].numpy(), [[1, 1], [2, 1]])
    rng = np.random.default_rng(3)
    b, n, c, segs = 2, 64, 8, 16
    f = rng.integers(-4, 5, (b, n, c)).astype(np.float32)
    ids = rng.integers(0, segs, (b, n)).astype(np.int32)
    ids[:, 5], ids[:, 9] = -1, segs
    ids[0, 20:24], ids[1, 30:33] = segs, -1
    got = k_ss.scatter_sum(_t(f), _t(ids), segs).numpy()
    pallas = scatter_sum_pallas(jnp.asarray(f), jnp.asarray(ids), segs,
                                interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def _conv_case(seed, r, cin, cout, b=2):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, r, r, r, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return g, k, bias, np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))


@pytest.mark.parametrize("name,r,cin,cout", [
    ("slab_odd", 5, 6, 8), ("slab_even", 8, 6, 8), ("whole_grid", 4, 6, 8),
    ("ms_pad_taps", 4, 6, 8), ("mm_unpadded_wide", 2, 264, 8)])
def test_conv3d_against_every_pallas_conv(name, r, cin, cout):
    """One kernel stands for every conv of the TPU table: its plain
    version on a float32 grid against each Pallas function in interpret
    mode, at the bf16 bound (they round grid and weights to bfloat16)."""
    g, k, bias, w_torch = _conv_case(r + cin, r, cin, cout)
    got = ops.voxel_conv3d(_t(g), _t(w_torch), _t(bias))
    assert got.dtype == torch.float32 and got.shape == (2, r, r, r, cout)
    args = (jnp.asarray(g), jnp.asarray(k), jnp.asarray(bias), r)
    want = {
        "slab_odd": lambda: conv3d_pallas(*args, True),
        "slab_even": lambda: conv3d_pallas(*args, True),
        "whole_grid": lambda: conv3d_wg_pallas(*args, True),
        "ms_pad_taps": lambda: conv3d_ms_pallas(*args, True, None, "pad"),
        "mm_unpadded_wide": lambda: conv3d_mm_pallas(*args, True),
    }[name]()
    assert want.dtype == jnp.float32          # the grid's dtype comes back
    _close(got.numpy(), want, BF16_TOL)


# ------------------------------------------------------------ gradients

def _grad_close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    assert scale > 0 and got.shape == want.shape
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_mean_grad(dtype):
    r, c = 4, 6
    _, f, ctx, jctx = _vox_inputs(31, r, c)
    cot = np.random.default_rng(32).standard_normal(
        (2, r, r, r, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.grad(lambda x: (jops.avg_voxelize_ctx(x, jctx, r)
                               * cot).sum())(jnp.asarray(f).astype(jdt))
    x = _t(f).to(tdt).requires_grad_()
    (ops.avg_voxelize(x, ctx, r) * _t(cot)).sum().backward()
    assert x.grad.dtype == tdt and want.dtype == jdt
    _grad_close(x.grad, want, 1e-5 if dtype == "float32" else BF16_ROUNDING)
    # raw sums: every point gets its voxel's cotangent undivided
    z = _t(f).requires_grad_()
    (k_vox.scatter_mean(z, ctx.order, ctx.ids_sorted, ctx.voxel_lo, r,
                        divide=False, ids=ctx.ids) * _t(cot)).sum().backward()
    flat = cot.reshape(2, r ** 3, c)
    np.testing.assert_array_equal(z.grad.numpy(), np.take_along_axis(
        flat, ctx.ids.numpy().astype(np.int64)[..., None], axis=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_grad(dtype):
    r, cin, cout = 4, 6, 8
    g, k, bias, w_torch = _conv_case(41, r, cin, cout)
    cot = np.random.default_rng(42).standard_normal(
        (2, r, r, r, cout)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # the Pallas forward does not enter the cotangents: the rule is an XLA
    # conv's VJP at the saved inputs
    want = jax.grad(
        lambda x, w, b_: (conv3d_ms(x, w, b_, r).astype(jnp.float32)
                          * cot).sum(), argnums=(0, 1, 2))(
        jnp.asarray(g).astype(jdt), jnp.asarray(k), jnp.asarray(bias))
    x = _t(g).to(tdt).requires_grad_()
    w = _t(w_torch).requires_grad_()
    b_ = _t(bias).requires_grad_()
    (ops.voxel_conv3d(x, w, b_).float() * _t(cot)).sum().backward()
    assert (x.grad.dtype, w.grad.dtype, b_.grad.dtype) == (
        tdt, torch.float32, torch.float32)
    assert (want[0].dtype, want[1].dtype, want[2].dtype) == (
        jdt, jnp.float32, jnp.float32)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    _grad_close(x.grad, want[0], tol)
    _grad_close(w.grad.permute(2, 3, 4, 1, 0), want[1], tol)
    _grad_close(b_.grad, want[2], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grad(dtype):
    rng = np.random.default_rng(51)
    q, k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    cot = rng.standard_normal((2, 64, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda *a: (attention_pallas(*a).astype(jnp.float32)
                                    * cot).sum(), argnums=(0, 1, 2))(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    ts = [_t(a).to(tdt).requires_grad_() for a in (q, k, v)]
    (k_attn.attention(*ts).float() * _t(cot)).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.dtype == tdt and w.dtype == jdt
        _grad_close(t.grad, w, 1e-5 if dtype == "float32" else BF16_TOL)


def test_interp_mm_grad():
    """bf16 features (the only dtype `interp_mm` takes): the gradient is
    the segment sum of the cotangent rows times the FLOAT32 weights, cast
    to bf16: one bf16 rounding against the reference's."""
    pts, ctr = _t(_cloud(61, 2, 512)), _t(_cloud(62, 2, 128))
    idx, w = ops.three_nn(pts, ctr)
    f = np.random.default_rng(63).standard_normal((2, 128, 24)).astype(
        np.float32)
    cot = np.random.default_rng(64).standard_normal((2, 512, 24)).astype(
        np.float32)
    want = jax.grad(lambda x: (jax_interp_mm(
        jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), x).astype(
        jnp.float32) * cot).sum())(jnp.asarray(f).astype(jnp.bfloat16))
    x = _t(f).to(torch.bfloat16).requires_grad_()
    before = k_ss.plain_cuda_calls
    (k_interp.interp_mm(idx, w, x).float() * _t(cot)).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert k_ss.plain_cuda_calls == before          # a CPU call counts none
    _grad_close(x.grad, want, BF16_ROUNDING)
    # through the dispatching op too
    y = _t(f).to(torch.bfloat16).requires_grad_()
    (ops.three_nn_interpolate(pts, ctr, y).float() * _t(cot)).sum().backward()
    np.testing.assert_array_equal(y.grad.float().numpy(),
                                  x.grad.float().numpy())


def test_scatter_sum_builds_no_graph():
    """It serves a backward rule and is no `autograd.Function`: on either
    device its result carries no gradient."""
    rng = np.random.default_rng(71)
    x = _t(rng.standard_normal((2, 40, 5)).astype(np.float32)).requires_grad_()
    ids = _t(rng.integers(0, 8, (2, 40)).astype(np.int32))
    out = k_ss.scatter_sum(x, ids, 8)
    assert not out.requires_grad
    torch.testing.assert_close(out.sum(1), x.detach().sum(1))


def test_index_ops_carry_no_gradient():
    pts = _t(_cloud(81, 2, 64)).requires_grad_()
    ctr = _t(_cloud(82, 2, 16)).requires_grad_()
    idx, w = ops.three_nn(pts, ctr)
    assert not w.requires_grad and not idx.requires_grad
    assert not ops.furthest_point_sample(pts, 8).requires_grad
    assert not ops.ball_query(ctr, pts, 0.5, 4).requires_grad


# ------------------------------------------------------------ dispatch

def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_counts()
    x = _t(_cloud(12, 1, 64))
    ops.furthest_point_sample(x, 8)
    ops.ball_query(x[:, :8], x, 0.5, 4)
    ops.three_nn(x, x[:, :8])
    ops.three_nn_interpolate(x, x[:, :8],
                             torch.zeros(1, 8, 4, dtype=torch.bfloat16),
                             impl="onehot")
    ctx = ops.make_voxel_context(x, 4)
    g = ops.avg_voxelize(x, ctx, 4)
    ops.voxel_conv3d(g, torch.zeros(4, 3, 3, 3, 3), torch.zeros(4))
    k_attn.attention(x, x, x)
    k_ss.scatter_sum(x, torch.zeros(1, 64, dtype=torch.int32), 2)
    k_gn.group_norm(x.repeat(1, 1, 8)[..., :16], torch.ones(16),
                    torch.zeros(16), 8, 1e-5, silu=True)
    assert set(kernels.counts()) == {
        "fps", "ball_query", "three_nn", "interp_mm", "scatter_mean",
        "scatter_sum", "conv3d", "attention", "groupnorm"}
    assert all(c == (0, 0) for c in kernels.counts().values()), \
        kernels.counts()


@pytest.mark.parametrize("call", [
    lambda t: k_fps.furthest_point_sample(t, 4),
    lambda t: k_bq.ball_query(t, t, 0.5, 4),
    lambda t: k_tnn.three_nn(t, t),
    lambda t: k_interp.interp_mm(
        t.new_zeros((1, 16, 3), dtype=torch.int32), t,
        t.new_zeros((1, 16, 8), dtype=torch.bfloat16)),
    lambda t: k_attn.attention(t, t, t),
    lambda t: k_vox.scatter_mean(
        t, *(t.new_zeros(s, dtype=torch.int32)
             for s in ((1, 16), (1, 16), (1, 9))), 2,
        ids=t.new_zeros((1, 16), dtype=torch.int32)),
    lambda t: k_conv.conv3d(t.new_zeros((1, 4, 4, 4, 3)),
                            t.new_zeros((4, 3, 3, 3, 3)), t.new_zeros(4)),
    lambda t: k_ss.scatter_sum(t, t.new_zeros((1, 16), dtype=torch.int32),
                               4),
    lambda t: k_gn.group_norm(t.new_zeros((1, 16, 8)), t.new_ones(8),
                              t.new_zeros(8), 8, 1e-5),
], ids=["fps", "ball_query", "three_nn", "interp_mm", "attention",
        "scatter_mean", "conv3d", "scatter_sum", "groupnorm"])
def test_non_cpu_tensor_never_falls_back(call):
    """A tensor off the CPU launches the kernel or raises; here (no CUDA
    device) a meta tensor must raise, not run the plain version."""
    kernels.reset_counts()
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        call(torch.zeros((1, 16, 3), device="meta"))
    assert all(c[1] == 0 for c in kernels.counts().values())


def test_package_imports_without_jax():
    code = ("import sys, bdm_tpu_torch, bdm_tpu_torch.ops, "
            "bdm_tpu_torch.models, bdm_tpu_torch.models.fusion, "
            "bdm_tpu_torch.samplers, bdm_tpu_torch.samplers.merging, "
            "bdm_tpu_torch.diffusion.ddim, bdm_tpu_torch.tools.standins, "
            "bdm_tpu_torch.train, "
            "bdm_tpu_torch.utils.convert_jax; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True)
