"""The arithmetic of the two tensor-core kernels of `bdm_tpu_torch`
(`csrc/attention.cu`, `csrc/conv3d.cu`), on the CPU at small sizes: what
surrounds the CUDA code and can be said in PyTorch.

  * the CUDA-core (float32) attention kernel's partition: eight lanes a
    query row, keys tk + 8 j and channels 4 tk + 32 ct a lane, the row
    maximum and sum reduced over the eight lanes by xor shuffles, the
    tile-wise rescale; and the CUDA-core conv's two implicit GEMMs on its
    packed (Kp, Cout_p) weights: im2col tiles (K tap-outer and
    channel-inner in 4-channel pieces, 16-deep stages) and, where
    R % 8 == 0, halo tiles (4-channel chunks outer, the 27 taps shifted
    views of a staged 4 x 10 x 10 halo), each tile covered once by its
    threads.
    float32 1e-5 of the largest entry against the plain version and the
    Pallas kernel in interpret mode (the conv on bf16-representable inputs,
    which the Pallas conv rounds to bfloat16);
  * the tiled online softmax of the attention kernel, emulated with its
    roundings (probabilities rounded to v's type for the second product,
    the row sum taken over the unrounded float32 probabilities, float32
    output rescaled a tile, `exp2` of log2(e)-scaled logits), against the
    port's plain version and the Pallas kernel in interpret mode: float32
    1e-5 of the largest entry (the same sums in another order), bfloat16
    1e-2 (one bfloat16 rounding of sums that differ in their last bits);
  * the packed weight layout of the bf16 conv kernel (one ring stage a
    (N tile, chunk, kd)): packed weights times the 27 shifted views of a
    zero-padded grid equal the plain conv, and the padding is zero; its
    N tile by Cout; and the warpgroup kernel's tiles, halo and weight
    stages and descriptor arithmetic (A rows 160 bytes a group of 8, the
    chunk's halves one halo apart; B rows 128 bytes a group of 8, the
    halves NT x 16 bytes apart), bf16 1e-2 against the plain conv;
  * the cache of packed weights: refreshed after an in-place update and
    after `load_state_dict`, kept otherwise;
  * `kernel_path` at every shape `chip_smoke.py` holds on the card;
  * the block reduction of the FPS kernel (`csrc/fps.cu`): strided
    ownership, a thread's pairwise tree in which the higher indices win
    only by a strict >, the warp's max over the
    distances' bits and then its min over the indices of the lanes that
    hold it, the block step over double-buffered slots, padding points;
    indices exact against the plain version and the Pallas kernel in
    interpret mode, on random clouds, the integer lattice (many exact
    ties), exact duplicates and N that is no multiple of T or of 32;
  * the split of a voxel row into lanes and vectors of the scatter-mean
    kernel (`csrc/voxelize.cu`): every channel written once, sums in the
    run's order, one rounding; equal to the plain version bit for bit;
  * the warp-ballot scan of the ball-query kernel (`csrc/ball_query.cu`):
    groups of 32 points, a hit's slot the count so far plus the hits of the
    lanes below it, ballots taken in ascending point order, the stop at the
    step that reaches U, the fill with the first hit; indices exact against
    the plain version and the Pallas kernel in interpret mode on random
    clouds, the integer lattice at r = 1.0 (d2 = r2 exactly for the face
    neighbours), duplicates, N no multiple of 32, N < U and a centre with
    no hit;
  * the CSR build of the scatter-sum kernel (`csrc/scatter_sum.cu`): the
    counts of a tile grouped by id with a rank a row, the scans over tiles
    and over segments, each row placed at its slot; `order` and `lo` equal
    a stable sort and a bincount, and the sums over the runs equal the
    plain version bit for bit, with ids out of range, a crowded segment and
    N no multiple of the tile;
  * the lane split of the three-NN kernel (`csrc/three_nn.cu`): a query's
    centres over L lanes in steps of U, each lane's three least steps by
    strict < with selects, the centres of those steps recomputed and their
    triples merged on (d, index), sentinels (+inf, INT_MAX) in lanes with
    fewer than three centres, xor-shuffle merges of sorted triples
    (min(a_k, b_(2-k)), then two compare-exchanges), several staged tiles,
    M < 3 repeating the last centre; indices exact against the plain
    version and the Pallas kernel in interpret mode on random clouds, the
    lattice against its cell centres, centres in duplicate pairs (a higher
    lane may hold the lower index), M no multiple of L U and M < L; and the
    split rule at the five FP levels of the paths;
  * the split of the blend kernel (`csrc/interp.cu`): blocks of T threads
    over rows of one batch element, thread t on channel group t % G of rows
    t / G + p T / G for p < R, each thread's indices (clamped) and
    bf16-rounded weights loaded once a row, groups past T in further
    spans of blocks, the ragged last block, one channel a group where
    C % 8 != 0;
    every output element written once, bit for bit the plain version, and
    within one bf16 rounding of the Pallas `interp_mm` in interpret mode
    (`tests/test_torch_ops.py::test_interp_mm_plain`'s tolerance); a warp's
    stores cover whole consecutive rows.
"""

import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bdm_tpu.ops.pallas.attention import attention_pallas
from bdm_tpu.ops.pallas.ball_query import ball_query_pallas
from bdm_tpu.ops.pallas.conv3d import conv3d_pallas
from bdm_tpu.ops.pallas.fps import furthest_point_sample_pallas
from bdm_tpu.ops.pallas.interp_mm import interp_mm as jax_interp_mm
from bdm_tpu.ops.pallas.three_nn import three_nn_pallas
from bdm_tpu.ops.sampling import furthest_point_sample as jax_fps
from bdm_tpu_torch import ops
from bdm_tpu_torch.models.pvcnn import VoxConv
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import (attention as k_attn,
                                    ball_query as k_bq, conv3d as k_conv,
                                    fps as k_fps, interp as k_interp,
                                    scatter_sum as k_ss,
                                    three_nn as k_tnn, voxelize as k_vox)

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOG2E = math.log2(math.e)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _packs():
    """The conv weight copies `conv3d.packed` made: its cache misses."""
    return kernels.tally()["conv3d", "packs"]


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


ROW_LANES = 8   # lanes that share a query row in `attention_simt_kernel`


def _lane_reduce(x, op):
    """The three xor shuffles (1, 2, 4) over the last axis of 8 lanes."""
    lane = torch.arange(ROW_LANES)
    for d in (1, 2, 4):
        x = op(x, x[..., lane ^ d])
    return x


def attention_simt(q, k, v, tile=64):
    """`attention_simt_kernel` of csrc/attention.cu in PyTorch: its block,
    lane partition, lane-reduced row maximum and sum, and tile-wise
    rescale; channels zero-padded to CP."""
    dt = v.dtype
    b, s, c = q.shape
    cp = 32 if c <= 32 else 64 if c <= 64 else 128
    tq, threads = (8, 256) if cp <= 64 else (4, 128)
    bq = tq * threads // ROW_LANES
    # every query row of a block and every channel once: lane (row group
    # rg, tk) owns rows rg * tq + i, keys tk + 8 j and channels
    # 4 tk + 32 ct + e
    rows = sorted(rg * tq + i for rg in range(threads // ROW_LANES)
                  for i in range(tq))
    assert rows == list(range(bq))
    chans = sorted(4 * tk + 32 * ct + e for tk in range(ROW_LANES)
                   for ct in range(cp // 32) for e in range(4))
    assert chans == list(range(cp))
    keys = sorted(tk + 8 * j for tk in range(ROW_LANES) for j in range(8))
    assert keys == list(range(tile))
    ntiles = -(-s // tile)
    pad = lambda t, rows: F.pad(t.float(), (0, cp - c, 0, rows - s))
    qf, kf, vf = pad(q, s), pad(k, ntiles * tile), pad(v, ntiles * tile)
    out = torch.zeros(b, s, cp)
    row_max = torch.full((b, s, 1), -math.inf)
    lane_sum = torch.zeros(b, s, ROW_LANES)      # each lane's share
    for k0 in range(0, ntiles * tile, tile):
        logits = qf @ kf[:, k0:k0 + tile].transpose(1, 2)
        logits[..., s - k0:] = -math.inf        # keys from s on
        # key tk + 8 j of the tile sits in lane tk: (j, tk)
        lanes = logits.reshape(b, s, 8, ROW_LANES)
        mx = _lane_reduce(lanes.amax(2), torch.maximum)
        assert (mx == mx[..., :1]).all()        # every lane has the row's
        new_max = torch.maximum(row_max, mx[..., :1])
        scale = torch.exp2((row_max - new_max) * LOG2E)
        p = torch.exp2(logits * LOG2E - new_max * LOG2E)
        lane_sum = lane_sum * scale + p.reshape(b, s, 8, ROW_LANES).sum(2)
        out = out * scale + p.to(dt).float() @ vf[:, k0:k0 + tile]
        row_max = new_max
    row_sum = _lane_reduce(lane_sum, torch.add)[..., :1]
    return (out * (1.0 / row_sum))[..., :c].to(dt)


@pytest.mark.parametrize("s,c", [(64, 16), (125, 12), (125, 48), (200, 64),
                                 (70, 128)], ids=lambda v: str(v))
def test_attention_simt_partition(s, c):
    rng = np.random.default_rng(s * c)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((2, s, c)).astype(np.float32) * 0.7)
        for _ in range(3))
    got = attention_simt(q, k, v)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, k_attn.attention_plain(q, k, v)) < TOL[torch.float32]
    pallas = attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    assert _rel(got, torch.from_numpy(np.array(pallas))) < TOL[torch.float32]


def conv_simt(x, weight, bias):
    """`conv3d_simt_kernel` of csrc/conv3d.cu in PyTorch: the implicit
    im2col matrix built piece by piece (4 channels of one tap, tap-outer),
    times the packed weights stage by stage (16 deep), bias in float32."""
    b, r, cin = x.shape[0], x.shape[1], x.shape[-1]
    cout = weight.shape[0]
    bn = k_conv.n_tile(torch.float32, cout)
    packed = k_conv.gemm_weight(weight, torch.float32)
    kp, cout_p = packed.shape
    cin4 = k_conv.padded(cin, k_conv.GEMM_CIN_STEP)
    assert kp % k_conv.GEMM_K_STEP == 0 and 0 <= kp - 27 * cin4 < 16
    assert cout_p % bn == 0 and not packed[:, cout:].any()
    taps = packed[:27 * cin4].reshape(27, cin4, cout_p)
    assert not taps[:, cin:].any() and not packed[27 * cin4:].any()
    # a block's BM x BN tile (the source's four tile shapes, BM, TN and
    # threads): thread t, with LN = BN / TN lanes across N, owns voxels
    # t // LN + RG i and columns 4 (t % LN) + 4 LN g + e, once each
    for bm, tn_, threads in {32: [(128, 4, 128), (128, 8, 64)],
                             64: [(128, 8, 128)]}[bn]:
        ln = bn // tn_
        rg = threads // ln
        cells = sorted((t // ln + rg * i, 4 * (t % ln) + 4 * ln * g + e)
                       for t in range(threads) for i in range(bm // rg)
                       for g in range(tn_ // 4) for e in range(4))
        assert cells == [(m, n) for m in range(bm) for n in range(bn)]
    halo = F.pad(x.float(), (0, cin4 - cin, 1, 1, 1, 1, 1, 1))
    npt = cin4 // 4
    cols = torch.zeros(b * r ** 3, kp)
    for piece in range(27 * npt):
        tap, c0 = divmod(piece, npt)
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        cols[:, 4 * piece:4 * piece + 4] = halo[
            :, kd:kd + r, kh:kh + r, kw:kw + r,
            4 * c0:4 * c0 + 4].reshape(-1, 4)
    acc = torch.zeros(b * r ** 3, cout_p)
    for k0 in range(0, kp, k_conv.GEMM_K_STEP):
        acc += cols[:, k0:k0 + 16] @ packed[k0:k0 + 16]
    out = acc + k_conv.pack_bias(bias, cout_p)
    return out[:, :cout].reshape(b, r, r, r, cout)


def conv_simt_halo(x, weight, bias):
    """`conv3d_simt_halo_kernel` of csrc/conv3d.cu (R % 8 == 0) in PyTorch:
    TZ x 8 x 8 output tiles (TZ 4 at Cout > 32, 2 below); per chunk of 4
    input channels the tile's (TZ + 2) x 10 x 10 halo and the chunk's
    weights of all 27 taps, the taps shifted views of the halo; the same
    packed weights."""
    b, r, cin = x.shape[0], x.shape[1], x.shape[-1]
    cout = weight.shape[0]
    tz, threads = ((2, 128) if k_conv.n_tile(torch.float32, cout) == 32
                   else (4, 256))
    assert r % 8 == 0 and r % tz == 0
    packed = k_conv.gemm_weight(weight, torch.float32)
    cout_p = packed.shape[1]
    cin4 = k_conv.padded(cin, k_conv.GEMM_CIN_STEP)
    # a block's 64 TZ voxels: with 8 lanes across N, thread t's rows
    # t // 8 + RG i (RG = threads / 8) are voxels of the row-major tile,
    # once each
    rg = threads // 8
    rows = sorted(t // 8 + rg * i for t in range(0, threads, 8)
                  for i in range(64 * tz // rg))
    assert rows == list(range(64 * tz))
    grid = F.pad(x.float(), (0, cin4 - cin, 1, 1, 1, 1, 1, 1))
    out = torch.zeros(b, r, r, r, cout_p)
    for z0 in range(0, r, tz):
        for y0 in range(0, r, 8):
            for x0 in range(0, r, 8):
                halo = grid[:, z0:z0 + tz + 2, y0:y0 + 10, x0:x0 + 10]
                acc = torch.zeros(b, tz, 8, 8, cout_p)
                for c0 in range(0, cin4, 4):
                    for tap in range(27):
                        dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
                        view = halo[:, dz:dz + tz, dy:dy + 8, dx:dx + 8,
                                    c0:c0 + 4]
                        rows = packed[tap * cin4 + c0:tap * cin4 + c0 + 4]
                        acc += view @ rows
                out[:, z0:z0 + tz, y0:y0 + 8, x0:x0 + 8] = acc
    out += k_conv.pack_bias(bias, cout_p)
    return out[..., :cout]


@pytest.mark.parametrize("cin,cout,r", [(3, 8, 5), (6, 32, 4), (16, 40, 4),
                                        (13, 70, 3), (1, 1, 2), (3, 8, 8),
                                        (6, 70, 8)],
                         ids=lambda v: str(v))
def test_conv_simt_tap_order(cin, cout, r):
    rng = np.random.default_rng(cin * cout)
    # values a bfloat16 holds: the Pallas conv's casts are exact then
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float()
    x = bf(rng.standard_normal((2, r, r, r, cin)))
    w = bf(rng.standard_normal((cout, cin, 3, 3, 3)) * (27 * cin) ** -0.5)
    bias = bf(rng.standard_normal(cout))
    # the source's rule: halo tiles where R % 8 == 0, else im2col tiles
    got = (conv_simt_halo if r % 8 == 0 else conv_simt)(x, w, bias)
    assert _rel(got, k_conv.conv3d_plain(x, w, bias)) < TOL[torch.float32]
    if r % 8 == 0:
        assert _rel(got, conv_simt(x, w, bias)) < TOL[torch.float32]
    pallas = conv3d_pallas(jnp.asarray(x.numpy()),
                           jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()),
                           jnp.asarray(bias.numpy()), r, True)
    assert _rel(got, torch.from_numpy(np.array(pallas))) < TOL[torch.float32]


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


def unpack_weight(packed):
    """`conv3d.pack_weight`'s layout -> (27, Cin_p, Cout_p), taps in
    (kd, kh, kw) order: what the warpgroup kernel multiplies."""
    ntiles, chunks, _, _, _, nt, _ = packed.shape
    return packed.permute(2, 3, 1, 4, 6, 0, 5).reshape(
        27, chunks * k_conv.CIN_STEP, ntiles * nt)


@pytest.mark.parametrize("cin,cout,r", [(3, 8, 5), (6, 32, 5), (32, 40, 5),
                                        (20, 70, 4), (8, 200, 3)])
def test_packed_weights(cin, cout, r):
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((2, r, r, r, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3, 3))
                         .astype(np.float32)) * (27 * cin) ** -0.5
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    packed = k_conv.pack_weight(w)
    nt = k_conv.n_tile(torch.bfloat16, cout)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # (N tile, chunk, kd, (kh, kw), 8-channel half, n, 8): one ring stage
    # of 9 x 16 x NT elements for each (N tile, chunk, kd)
    assert packed.shape[2:] == (3, 9, 2, nt, 8)
    assert packed[0, 0, 0].numel() * 2 == 9 * 16 * nt * 2
    taps = unpack_weight(packed)
    cin_p, cout_p = taps.shape[1:]
    assert taps.shape[0] == 27 and packed.shape[:2] == (cout_p // nt,
                                                        cin_p // 16)
    assert cin_p % 16 == 0 and 0 <= cin_p - cin < 16
    assert cout_p % nt == 0 and cout_p - cout < nt
    assert not taps[:, cin:].any() and not taps[:, :, cout:].any()
    assert torch.equal(taps[:, :cin, :cout], w.to(torch.bfloat16).permute(
        2, 3, 4, 1, 0).reshape(27, cin, cout))
    bias_p = k_conv.pack_bias(bias, cout_p)
    assert bias_p.dtype == torch.float32 and not bias_p[cout:].any()
    got = _conv_by_taps(x, taps, bias_p, cout)
    assert _rel(got, k_conv.conv3d_plain(x, w, bias)) < TOL[torch.bfloat16]


def conv_wgmma(x, weight, bias, planes):
    """`conv3d_wgmma_kernel` of csrc/conv3d.cu in PyTorch, on bf16 inputs.
    A block: 2 consumer warpgroups of `planes` z-planes of 8 x 8 output
    voxels (TZ = 2 planes) times an N tile of `n_tile`. Its shared memory
    is emulated in 16-byte units (8 channels): a chunk's halo stage
    [half][hz][hy][hx] of (TZ + 2) x 10 x 10 voxels, zeros outside the grid
    and past Cin; a weight stage, one (N tile, chunk, kd) of the packed
    weights read as is. Each product reads its operands through the
    descriptors' arithmetic: A row m of plane p at tap (kd, kh, kw) is
    unit start + (m // 8) SBO + m % 8 (+ LBO for the chunk's second
    half), start = the plane's voxel (p + kd, kh, kw), SBO one halo row
    (10 units, 160 bytes), LBO one half (the halo's voxels); B row n of tap
    t9 is unit 2 NT t9 + (n // 8) 8 + n % 8 (+ NT), SBO 128 bytes. Float32
    sums, bias in float32, one rounding."""
    b, r, cin = x.shape[0], x.shape[1], x.shape[-1]
    cout = weight.shape[0]
    nt = k_conv.n_tile(torch.bfloat16, cout)
    packed = k_conv.pack_weight(weight)
    ntiles, chunks = packed.shape[:2]
    tz = 2 * planes
    hv = (tz + 2) * 100
    bias_p = k_conv.pack_bias(bias, ntiles * nt)
    grid = F.pad(x.float(), (0, chunks * 16 - cin, 1, 9, 1, 9, 1, tz + 1))
    out = torch.zeros(b, r, r, r, cout)
    m = torch.arange(64)
    n = torch.arange(nt)
    for z0 in range(0, r, tz):
        for y0 in range(0, r, 8):
            for x0 in range(0, r, 8):
                halo = grid[:, z0:z0 + tz + 2, y0:y0 + 10, x0:x0 + 10]
                for ti in range(ntiles):
                    acc = torch.zeros(b, tz, 64, nt)
                    for c in range(chunks):
                        # [half][voxel] -> 16-byte units of 8 channels
                        units = halo[..., 16 * c:16 * c + 16].reshape(
                            b, hv, 2, 8).transpose(1, 2).reshape(b, 2 * hv, 8)
                        for kd in range(3):
                            stage = packed[ti, c, kd].float().reshape(-1, 8)
                            for t9 in range(9):
                                kh, kw = divmod(t9, 3)
                                rows_b = 2 * nt * t9 + (n // 8) * 8 + n % 8
                                bt = torch.cat([stage[rows_b],
                                                stage[rows_b + nt]], 1)
                                for p in range(tz):
                                    start = ((p + kd) * 10 + kh) * 10 + kw
                                    rows_a = start + (m // 8) * 10 + m % 8
                                    a = torch.cat([units[:, rows_a],
                                                   units[:, rows_a + hv]], 2)
                                    acc[:, p] += a @ bt.T
                    y = (acc + bias_p[ti * nt:(ti + 1) * nt]).reshape(
                        b, tz, 8, 8, nt)
                    zs, ys, xs = (min(tz, r - z0), min(8, r - y0),
                                  min(8, r - x0))
                    cols = min(nt, cout - ti * nt)
                    out[:, z0:z0 + zs, y0:y0 + ys, x0:x0 + xs,
                        ti * nt:ti * nt + cols] = y[:, :zs, :ys, :xs, :cols]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("cin,cout,r,planes", [
    (3, 32, 8, 1), (6, 8, 5, 1), (40, 64, 8, 2), (16, 7, 9, 1),
    (20, 130, 8, 1), (24, 32, 9, 4), (1, 1, 3, 1), (32, 200, 4, 2)],
    ids=lambda v: str(v))
def test_conv_wgmma_addressing(cin, cout, r, planes):
    """The warpgroup kernel's tiles, rings and descriptor arithmetic on the
    packed weights give the plain conv: ragged grids, Cin odd, even and a
    multiple of 8 and 16, Cout below, at and past an N tile, every
    planes-a-warpgroup the source instantiates (1, 2, 4)."""
    rng = np.random.default_rng(cin * 7 + cout)
    x = torch.from_numpy(rng.standard_normal((2, r, r, r, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3, 3))
                         .astype(np.float32)) * (27 * cin) ** -0.5
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = conv_wgmma(x, w, bias, planes)
    assert got.shape == (2, r, r, r, cout)
    assert _rel(got, k_conv.conv3d_plain(x, w, bias)) < TOL[torch.bfloat16]


def stage_by_vectors(raw, start, end, cin, voxel, c0, read):
    """`wg_stage_halo` of csrc/conv3d.cu for one voxel of a grid whose rows
    are not 16-byte aligned: `raw` the bytes of the allocation, the grid
    from byte `start` to `end`. The chunk's 32 bytes (channels c0 .. c0 +
    15) from the three aligned 16-byte words around them, a word loaded
    only if it starts before `end` (its start noted in `read`); a shift by
    whole words (2, then 1), then by half a word; zeros past Cin. -> the 16
    channels' bits."""
    a = start + 2 * (voxel * cin + c0)
    word0, shift = a & ~15, a & 15
    v = []
    for q in range(3):
        w = word0 + 16 * q
        if w < end:
            read.append(w)
            v += list(np.frombuffer(raw[w:w + 16].tobytes(), np.uint32))
        else:
            v += [0] * 4
    o = shift >> 2
    if o & 2:
        v = v[2:] + [0, 0]
    if o & 1:
        v = v[1:] + [0]
    out = []
    for i in range(8):
        word = int(v[i])
        if shift & 2:
            word = ((int(v[i + 1]) << 32 | word) >> 16) & 0xFFFFFFFF
        for half in range(2):
            ch = c0 + 2 * i + half
            out.append(0 if ch >= cin else (word >> (16 * half)) & 0xFFFF)
    return out


@pytest.mark.parametrize("cin", [390, 391, 3, 67, 6, 774])
@pytest.mark.parametrize("lead", [0, 1, 3])
def test_conv_halo_by_vectors(cin, lead):
    """The warpgroup kernel's halo without TMA: for every voxel and chunk
    of a grid that starts `lead` elements into its allocation (a batch
    slice), the shifted aligned words give the voxel's channels, zeros past
    Cin; every word read starts inside the grid's aligned span (so in its
    pages)."""
    rng = np.random.default_rng(cin + lead)
    voxels = 5
    grid = rng.integers(1, 2 ** 15, size=voxels * cin).astype(np.uint16)
    # the allocation: `lead` elements, the grid, then bytes past it
    raw = np.concatenate([
        rng.integers(1, 2 ** 15, size=lead).astype(np.uint16), grid,
        np.full(32, 0xFFFF, np.uint16)]).view(np.uint8)
    start, end = 2 * lead, 2 * (lead + voxels * cin)
    read = []
    for voxel in range(voxels):
        for c0 in range(0, cin, 16):
            got = stage_by_vectors(raw, start, end, cin, voxel, c0, read)
            want = [int(grid[voxel * cin + c]) if c < cin else 0
                    for c in range(c0, c0 + 16)]
            assert got == want, (voxel, c0)
    assert min(read) >= start & ~15 and max(read) < end


@pytest.mark.parametrize("cout,bf16,f32", [(1, 32, 32), (32, 32, 32),
                                           (33, 64, 64), (64, 64, 64),
                                           (65, 128, 64), (128, 128, 64),
                                           (130, 128, 64), (256, 128, 64)])
def test_conv_n_tile(cout, bf16, f32):
    """The warpgroup kernel computes every channel of Cout <= 128 in one
    block (its halo staged once); the CUDA-core kernels 32 or 64."""
    assert k_conv.n_tile(torch.bfloat16, cout) == bf16
    assert k_conv.n_tile(torch.float32, cout) == f32


@pytest.mark.parametrize("how", ["add_", "load_state_dict"])
def test_packed_cache_follows_the_parameter(how):
    conv = VoxConv(6, 8)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    args = (conv.weight, conv.bias, torch.bfloat16)
    before = _packs()
    w0, b0 = k_conv.packed(*args)
    w1, b1 = k_conv.packed(*args)
    assert w1 is w0 and b1 is b0 and _packs() == before + 1
    # the float32 layout is a second entry of the same weight: (Kp,
    # Cout_p), the 6 channels of a tap padded to 8, 27 * 8 to 224 rows
    g0, _ = k_conv.packed(conv.weight, conv.bias, torch.float32)
    assert g0.shape == (224, 32) and k_conv.packed(*args)[0] is w0
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
    before = _packs()
    for _ in range(3):
        Probe.apply(x, conv.weight, conv.bias)
    with torch.inference_mode():
        Probe.apply(x, conv.weight, conv.bias)
    assert _packs() == before + 1
    other = torch.nn.Parameter(torch.zeros_like(conv.weight))
    Probe.apply(x, other, conv.bias)
    assert _packs() == before + 2


@pytest.mark.parametrize("cin,cout,r", chip_smoke.CONVS + [
    (3, 32, 9), (6, 8, 5), (16, 7, 5), (1, 1, 1), (64, 130, 9)])
def test_conv_kernel_path(cin, cout, r):
    """Every bf16 shape class (Cin odd, even and a multiple of 8; Cout
    ragged; R odd) takes the warpgroup kernel, every float32 one the
    CUDA-core kernels; the codes are the source's."""
    assert k_conv.kernel_path(torch.bfloat16, cin, cout, r) == "wgmma"
    assert k_conv.kernel_path(torch.float32, cin, cout, r) == "simt"
    assert k_conv.PATH_CODES == {"simt": 0, "wgmma": 2}
    assert set(k_conv.PATH_CODES) == set(kernels.PATHS["conv3d"])


@pytest.mark.parametrize("s,c", chip_smoke.ATTNS + [(729, 16), (64, 8)])
def test_attention_kernel_path(s, c):
    assert k_attn.kernel_path(torch.bfloat16, s, c) == "tc"
    assert k_attn.kernel_path(torch.float32, s, c) == "simt"


def test_attention_kernel_path_odd_width():
    assert k_attn.kernel_path(torch.bfloat16, 200, 12) == "simt"


# ------------------------------------------------------------------ FPS

NO_INDEX = 2 ** 32 - 1   # UINT_MAX: a key that loses every min


def fps_block(coords, m, nt):
    """`fps_kernel` of csrc/fps.cu in PyTorch, for a block of `nt` threads:
    thread t holds the points t, t + nt, ... (K of them, K a power of two,
    padding at distance 0 past N)."""
    b, n, _ = coords.shape
    k = 1 << (-(-n // nt) - 1).bit_length()
    total = k * nt
    pts = torch.zeros(b, total, 3)
    pts[:, :n] = coords
    dist = torch.zeros(b, total)
    dist[:, :n] = 1e38
    index = torch.arange(total).reshape(k, nt)      # [slot, thread]
    nwarps = nt // 32
    live = torch.arange(32) < nwarps                # lanes reading a slot
    slots = torch.zeros(2, b, 32, 2, dtype=torch.int64)
    out = torch.zeros(b, m, dtype=torch.int32)
    last = pts[:, 0]
    rows = torch.arange(b)
    for j in range(1, m):
        dist = torch.minimum(dist, k_fps.sqdist(pts, last[:, None]))
        d = dist.reshape(b, k, nt)
        # a thread's argmax as a pairwise tree: the right side, whose
        # indices are higher, wins only by a strict >
        vals = [d[:, slot] for slot in range(k)]
        idxs = [index[slot].expand(b, nt) for slot in range(k)]
        w = 1
        while w < k:
            for slot in range(0, k - w, 2 * w):
                upd = vals[slot + w] > vals[slot]
                vals[slot] = torch.where(upd, vals[slot + w], vals[slot])
                idxs[slot] = torch.where(upd, idxs[slot + w], idxs[slot])
            w *= 2
        best, best_i = vals[0], idxs[0]
        # distances are >= +0: their bits order as the floats do
        bits = best.view(torch.int32).long().reshape(b, nwarps, 32)
        wmax = bits.amax(-1)
        widx = torch.where(bits == wmax[..., None],
                           best_i.reshape(b, nwarps, 32), NO_INDEX).amin(-1)
        slots[j & 1, :, :nwarps] = torch.stack([wmax, widx], -1)
        # after the barrier every warp reduces the slots of this parity
        sb = torch.where(live, slots[j & 1, ..., 0], 0)
        si = torch.where(live, slots[j & 1, ..., 1], NO_INDEX)
        picked = torch.where(sb == sb.amax(-1, keepdim=True), si,
                             NO_INDEX).amin(-1)
        assert (picked < n).all()
        out[:, j] = picked.to(torch.int32)
        last = pts[rows, picked]
    return out


def _fps_cloud(kind, n):
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.standard_normal((2, n, 3)).astype(np.float32) * 0.3
    if kind == "lattice":           # 64 distinct points, repeated
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        pts = np.concatenate([g] * (n // len(g) + 1))[:n].astype(np.float32)
        return np.broadcast_to(pts, (2, n, 3)).copy()
    half = rng.standard_normal((2, -(-n // 2), 3)).astype(np.float32)
    dup = np.concatenate([half, half[:, ::-1]], 1)[:, :n]   # duplicates
    return np.ascontiguousarray(dup[:, rng.permutation(n)])


@pytest.mark.parametrize("kind,n,m", [
    ("random", 256, 64), ("random", 1000, 200), ("lattice", 96, 96),
    ("lattice", 256, 100), ("duplicates", 200, 120), ("random", 64, 64),
    ("lattice", 64, 64)], ids=lambda v: str(v))
@pytest.mark.parametrize("nt", [None, 32, 64, 1024],
                         ids=["rule", "T32", "T64", "T1024"])
def test_fps_block_reduction(kind, n, m, nt):
    x = _fps_cloud(kind, n)
    nt = nt or k_fps.threads(n)
    got = fps_block(torch.from_numpy(x), m, nt)
    want = k_fps.furthest_point_sample_plain(torch.from_numpy(x), m)
    assert torch.equal(got, want)
    pallas = furthest_point_sample_pallas(jnp.asarray(x), m, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_fps_lowest_lane_is_not_lowest_index():
    """Two tied maxima in one warp: lane 1 holds index 1 + T, lane 2
    index 2. A first-lane pick would take 1 + T; the min over indices
    takes 2."""
    n, nt = 128, 64
    x = torch.zeros(1, n, 3)
    x[0, 2] = torch.tensor([5.0, 0.0, 0.0])
    x[0, 1 + nt] = torch.tensor([-5.0, 0.0, 0.0])
    assert fps_block(x, 2, nt)[0, 1] == 2
    assert k_fps.furthest_point_sample_plain(x, 2)[0, 1] == 2


@pytest.mark.parametrize("n", [64, 96, 256, 1000, 1024, 2048, 4096, 14528,
                               16384, 20000, 40000])
def test_fps_threads(n):
    t = k_fps.threads(n)
    assert t % 32 == 0 and 32 <= t <= 1024
    k = -(-n // t)
    assert t == 1024 or t >= n / k_fps.POINTS_A_THREAD
    # points a thread: K, a power of two, in registers up to K 16 (N
    # 16,384), streamed above it, so every N has a kernel
    kp = k_fps.points(n)
    assert kp >= k and kp < 2 * k and kp & (kp - 1) == 0
    assert (kp <= k_fps.MAX_REGISTER_POINTS) == (n <= 16384)


def test_fps_plain_matches_jax_at_n16384():
    """The plain version, which the card's indices are held to at N past
    the registers' K 16, against the JAX FPS with Pallas off."""
    x = _fps_cloud("random", 16384)
    got = k_fps.furthest_point_sample_plain(torch.from_numpy(x), 64)
    want = jax_fps(jnp.asarray(x), 64, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- scatter-mean

def scatter_mean_lanes(features, order, voxel_lo, r, out_dtype, divide,
                       threads=128):
    """`scatter_mean_kernel` of csrc/voxelize.cu in PyTorch: block and
    group to voxel, lane and pass to vector, vector to channels; the sum of
    each channel over the voxel's run in its order, in float32, rounded
    once."""
    b, n, c = features.shape
    vec, lanes = k_vox.kernel_path(features.dtype, out_dtype, c)
    nvec = c // vec
    # vectors a lane a pass: the least power of two that covers the row,
    # at most 16 floats a lane (`runs.cuh::pick_u`)
    per_pass = min(16 // vec, 1 << (-(-nvec // lanes) - 1).bit_length())
    voxels = b * r ** 3
    per_block = threads // lanes
    # the channels each thread of a block stores, pass by pass
    chans = [[] for _ in range(threads)]
    for tid in range(threads):
        lane = tid % lanes
        base = lane
        while base < nvec:
            for u in range(per_pass):
                e = base + u * lanes
                if e < nvec:
                    chans[tid].extend(range(e * vec, e * vec + vec))
            base += lanes * per_pass
    for g in range(per_block):         # every group covers its row once
        group = sum((chans[t] for t in range(g * lanes, (g + 1) * lanes)),
                    [])
        assert sorted(group) == list(range(c))
    # the voxel of each group: consecutive in a block, so a block writes
    # one contiguous span of the grid
    blocks = -(-voxels // per_block)
    vg = (torch.arange(blocks)[:, None] * per_block
          + torch.arange(per_block)[None]).reshape(-1)
    assert torch.equal(vg[:voxels], torch.arange(voxels))
    # the run of each voxel, walked in order
    lo = voxel_lo[:, :-1].reshape(-1).long()
    hi = voxel_lo[:, 1:].reshape(-1).long()
    bidx = torch.arange(voxels) // r ** 3
    cnt = ((hi - lo).float() if divide else torch.ones(voxels))[:, None]
    acc = torch.zeros(voxels, c)
    for step in range(int((hi - lo).max())):
        p = lo + step
        live = p < hi
        pt = order[bidx, p.clamp(max=n - 1)].long()
        x = features[bidx, pt].float()
        acc = torch.where(live[:, None], acc + x / cnt, acc)
    return acc.to(out_dtype).reshape((b,) + (r,) * 3 + (c,))


@pytest.mark.parametrize("divide", [True, False], ids=["mean", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 3, 7, 32, 64, 390, 512])
def test_scatter_mean_lanes(c, dtype, divide):
    rng = np.random.default_rng(c)
    pts = torch.from_numpy(rng.standard_normal((2, 300, 3))
                           .astype(np.float32) * 0.3)
    # crowd a third of the points into one voxel
    pts[:, :100] = pts[:, :1]
    ctx = ops.make_voxel_context(pts, 4)
    f = torch.from_numpy(rng.standard_normal((2, 300, c))
                         .astype(np.float32)).to(dtype)
    args = (f, ctx.order, ctx.voxel_lo, 4, dtype, divide)
    got = scatter_mean_lanes(*args)
    want = k_vox.scatter_mean_plain(f, ctx.order, ctx.ids_sorted,
                                    ctx.voxel_lo, 4, dtype, divide)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,r,n", chip_smoke.SITES)
def test_scatter_mean_path(c, r, n):
    """The rule of `kernel_path` at every site `chip_smoke.py` holds (where
    it is compared with the source's): 16-byte vectors when the row
    allows, the widest that divides C otherwise, lanes enough for the row
    up to a warp."""
    for dt in (torch.float32, torch.bfloat16):
        vec, lanes = k_vox.kernel_path(dt, dt, c)
        size = dt.itemsize
        assert c % vec == 0 and vec * size <= 16
        assert (vec * size == 16) == (c * size % 16 == 0)
        assert lanes == min(32, 1 << (c // vec - 1).bit_length())
    assert k_vox.kernel_path(torch.bfloat16, torch.bfloat16, 390) == (2, 32)
    assert k_vox.kernel_path(torch.float32, torch.float32, 64) == (4, 16)
    assert k_vox.kernel_path(torch.bfloat16, torch.float32, 3) == (1, 4)


# ---------------------------------------------------------- ball query

LANES = torch.arange(32)
BELOW = (1 << LANES) - 1            # lanemask_lt of each lane


def _popc(x):
    """Set bits of each entry of an int64 tensor below 2^32."""
    return sum((x >> k) & 1 for k in range(32))


def ball_query_warps(centers, points, radius, u, groups=4):
    """`ball_query_kernel` of csrc/ball_query.cu in PyTorch: one warp a
    centre; a step tests `groups` groups of 32 points while the count is
    below U, their ballots taken in ascending order."""
    b, m, _ = centers.shape
    n = points.shape[1]
    r2 = k_bq.radius_squared(radius)
    c = centers.reshape(b * m, 1, 3)
    cloud = points.repeat_interleave(m, 0)               # (B * M, N, 3)
    w = torch.arange(b * m)
    count = torch.zeros(b * m, dtype=torch.int64)
    first = torch.full((b * m,), -1)
    out = torch.full((b * m, u), -1, dtype=torch.int32)
    for p0 in range(0, n, 32 * groups):
        running = count < u                  # the loop's test, a step
        for g in range(groups):
            p = p0 + 32 * g + LANES
            live = p < n
            d2 = k_fps.sqdist(c, cloud[:, p.clamp(max=n - 1)])
            hit = running[:, None] & live & (d2 < r2)
            hits = (hit.long() << LANES).sum(1)                 # the ballot
            lowest = (hits & -hits).float().log2().long()       # __ffs - 1
            first = torch.where((first < 0) & (hits != 0), p0 + 32 * g
                                + lowest, first)
            slot = count[:, None] + _popc(hits[:, None] & BELOW)
            keep = hit & (slot < u)
            out[w[:, None].expand_as(slot)[keep], slot[keep]] = (
                p.expand_as(slot)[keep].int())
            count = count + _popc(hits)
    fill = first.clamp(min=0).int()
    empty = torch.arange(u)[None] >= count.clamp(max=u)[:, None]
    out = torch.where(empty, fill[:, None], out)
    assert (out >= 0).all()
    return out.reshape(b, m, u)


def _bq_cloud(kind, n):
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.standard_normal((2, n, 3)).astype(np.float32) * 0.3
    if kind == "lattice":
        return _fps_cloud("lattice", n)
    return _fps_cloud("duplicates", n) * 0.3


@pytest.mark.parametrize("kind,n,m,r", [
    ("random", 256, 32, 0.2), ("random", 200, 16, 0.5),
    ("lattice", 256, 32, 1.0), ("duplicates", 200, 16, 0.3),
    ("random", 20, 4, 0.4), ("lattice", 20, 4, 1.0)],
    ids=lambda v: str(v))
def test_ball_query_warp_ballots(kind, n, m, r):
    x = _bq_cloud(kind, n)
    c = x[:, :m].copy()
    c[:, -1] = 50.0                            # a centre with no hit
    got = ball_query_warps(torch.from_numpy(c), torch.from_numpy(x), r, 32)
    want = k_bq.ball_query_plain(torch.from_numpy(c), torch.from_numpy(x), r,
                                 32)
    assert torch.equal(got, want)
    assert (got[:, -1] == 0).all()
    pallas = ball_query_pallas(jnp.asarray(c), jnp.asarray(x), r, 32,
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_ball_query_strict_radius_on_the_lattice():
    """At r = 1.0 the face neighbours of a lattice point lie at d2 = r2
    exactly: only the point itself and its duplicates are in."""
    x = torch.from_numpy(_bq_cloud("lattice", 256))
    got = ball_query_warps(x[:, :8], x, 1.0, 8)
    assert ((x[:, got[0, 0].long()] == x[:, :1]).all())
    assert torch.equal(got[0, 0], torch.tensor([0, 64, 128, 192, 0, 0, 0, 0],
                                               dtype=torch.int32))


# ---------------------------------------------------------- scatter-sum

def scatter_sum_csr(ids, s, tile):
    """count, scan and place of csrc/scatter_sum.cu in PyTorch -> (order,
    lo). count: a warp a tile of one batch element, 32 ids a step in index
    order; the lanes of one id form a group, its highest lane takes the
    group's next counts and a lane's rank adds the lanes of its group below
    it. tiles: each segment's counts scanned over the tiles, and its
    total. scan: the totals scanned over the segments. place: a row goes to
    the start of its id's run, plus the rows of that id in earlier tiles,
    plus its rank."""
    b, n = ids.shape
    tiles = k_ss.tiles(n, tile)
    counts = torch.zeros(b, tiles, s, dtype=torch.int64)
    rank = torch.full((b, n), -1, dtype=torch.int64)
    for bi in range(b):
        for t in range(tiles):
            hi = min(n, (t + 1) * tile)
            for i0 in range(t * tile, hi, 32):
                i = i0 + LANES
                idv = torch.where(i < hi, ids[bi, i.clamp(max=n - 1)], -1)
                idv = torch.where((idv >= 0) & (idv < s), idv, -1).long()
                peers = idv[:, None] == idv[None, :]       # __match_any_sync
                leader = (peers * LANES).amax(1)
                lead = (idv >= 0) & (leader == LANES)
                first = torch.where(lead, counts[bi, t, idv.clamp(min=0)], 0)
                counts[bi, t, idv[lead]] += peers.sum(1)[lead]
                below = (peers & (LANES[None] < LANES[:, None])).sum(1)
                valid = idv >= 0
                rank[bi, i[valid]] = (first[leader] + below)[valid]
    before = counts.cumsum(1) - counts                        # tiles
    lo = torch.zeros(b, s + 1, dtype=torch.int64)             # scan
    lo[:, 1:] = counts.sum(1).cumsum(1)
    order = torch.full((b, n), -1, dtype=torch.int64)         # place
    valid = (ids >= 0) & (ids < s)
    bi, i = valid.nonzero(as_tuple=True)
    idv = ids[bi, i].long()
    order[bi, lo[bi, idv] + before[bi, i // tile, idv] + rank[bi, i]] = i
    return order, lo


def run_sums(features, order, lo):
    """The sum over runs of csrc/runs.cuh: each segment's rows in the run's
    order, in float32, from zero."""
    b, s = lo.shape[0], lo.shape[1] - 1
    bidx = torch.arange(b)[:, None].expand(b, s)
    start, stop = lo[:, :-1], lo[:, 1:]
    acc = torch.zeros(b, s, features.shape[-1])
    for step in range(int((stop - start).max().clamp(min=0))):
        p = start + step
        live = p < stop
        rows = features[bidx, order[bidx, p.clamp(max=order.shape[1] - 1)]
                        .clamp(min=0)].float()
        acc = torch.where(live[..., None], acc + rows, acc)
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,s,tile", [(200, 16, 64), (300, 40, 256),
                                      (96, 8, 32), (500, 700, None)],
                         ids=lambda v: str(v))
def test_scatter_sum_csr(n, s, tile, dtype):
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(rng.integers(-2, s + 2, (2, n)).astype(np.int32))
    ids[0, : n // 2] = 3                      # a crowded segment
    ids[1, 5], ids[1, 7] = -1, s              # out of range
    tile = tile or k_ss.tile(n, s)
    order, lo = scatter_sum_csr(ids, s, tile)
    valid = (ids >= 0) & (ids < s)
    keys = torch.where(valid, ids, s).long()
    want = torch.sort(keys, dim=1, stable=True).indices
    kept = valid.sum(1)
    for bi in range(2):
        k = int(kept[bi])
        assert torch.equal(order[bi, :k], want[bi, :k])
        assert (order[bi, k:] == -1).all()     # dropped rows get no slot
        assert torch.equal(lo[bi, 1:] - lo[bi, :-1],
                           torch.bincount(ids[bi][valid[bi]].long(),
                                          minlength=s))
    f = torch.from_numpy(rng.standard_normal((2, n, 24))
                         .astype(np.float32)).to(dtype)
    assert torch.equal(run_sums(f, order, lo),
                       k_ss.scatter_sum_plain(f, ids, s))


@pytest.mark.parametrize("n,s,t", [(12288, 1024, 256), (3072, 256, 256),
                                   (5000, 40000, 2048), (64, 10 ** 6, 256),
                                   (0, 8, 256)])
def test_scatter_sum_tile(n, s, t):
    """The counter table stays within 4 (N + S) entries a batch element
    (or a tile covers all N)."""
    assert k_ss.tile(n, s) == t and t % 32 == 0
    assert (k_ss.tiles(n, t) * s <= 4 * (n + s)) or t >= n


# ------------------------------------------------------------- three-NN

NONE = 2 ** 31 - 1       # INT_MAX: a sentinel's index, after every centre
NO_STEP = 2 ** 32 - 1    # UINT_MAX: no step yet


def _insert(v, s, x, j, take):
    """`insert` of csrc/three_nn.cu: strict < insertion of (x, j) into the
    sorted triples (v, s) where `take`, with selects."""
    p0, p1, p2 = (take & (x < v[..., k]) for k in range(3))
    v0, v1, v2 = v.unbind(-1)
    s0, s1, s2 = s.unbind(-1)
    return (torch.stack([torch.where(p0, x, v0),
                         torch.where(p0, v0, torch.where(p1, x, v1)),
                         torch.where(p1, v1, torch.where(p2, x, v2))], -1),
            torch.stack([torch.where(p0, j, s0),
                         torch.where(p0, s0, torch.where(p1, j, s1)),
                         torch.where(p1, s1, torch.where(p2, j, s2))], -1))


def _before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def _merge(d, i, e, f):
    """`merge`: the three least of two sorted, disjoint triples on
    (d, index). min(a_k, b_(2-k)) is a bitonic triple; the compare-exchanges
    (0, 2) and (1, 2) sort it."""
    e, f = e.flip(-1), f.flip(-1)
    o = _before(e, f, d, i)
    d, i = torch.where(o, e, d), torch.where(o, f, i)
    for a, b in ((0, 2), (1, 2)):
        sw = _before(d[..., b], i[..., b], d[..., a], i[..., a])
        da, ia, db, ib = d[..., a], i[..., a], d[..., b], i[..., b]
        d, i = d.clone(), i.clone()
        d[..., a], i[..., a] = torch.where(sw, db, da), torch.where(sw, ib, ia)
        d[..., b], i[..., b] = torch.where(sw, da, db), torch.where(sw, ia, ib)
    return d, i


def three_nn_lanes(points, centers, lanes=None, step=None, tile=None):
    """`three_nn_kernel` of csrc/three_nn.cu in PyTorch. The centres of a
    query are split over L lanes; lane s scans the steps s, s + L, ... of U
    consecutive centres, staged a tile at a time and padded to whole steps
    for every lane with centres at +inf. Phase 1: each step's least
    distance into the lane's three least steps (strict <). Phase 2 (U > 1):
    the centres of those steps, each step's best three by strict <, the
    three triples merged on (d, index); with U = 1 the steps are the
    centres. Then log2 L xor-shuffle rounds merge the lanes' triples; a lane
    with fewer than three centres holds (+inf, INT_MAX). M < 3 repeats the
    last centre found."""
    b, n, _ = points.shape
    m = centers.shape[1]
    lanes = lanes or k_tnn.lanes(b, n, m)
    step = step or k_tnn.step(m)
    tile = tile or k_tnn.TILE
    sub = torch.arange(lanes)
    rows = torch.arange(b)[:, None, None]
    pts = points[:, :, None, :]                           # (B, N, 1, 3)
    shape = (b, n, lanes, 3)
    t_d = torch.full(shape, math.inf)
    t_i = torch.full(shape, NONE, dtype=torch.int64)
    for t0 in range(0, m, tile):
        lim = min(tile, m - t0)
        steps = -(-lim // (lanes * step)) * lanes
        staged = torch.full((b, steps * step, 3), math.inf)
        staged[:, :lim] = centers[:, t0:t0 + lim]
        v = torch.full(shape, math.inf)
        s = torch.full(shape, NO_STEP, dtype=torch.int64)
        for k in range(steps // lanes):
            st = sub + k * lanes                          # each lane's step
            x = torch.stack([k_fps.sqdist(pts, staged[:, None, st * step + u])
                             for u in range(step)]).amin(0)   # (B, N, L)
            v, s = _insert(v, s, x, st.expand_as(x),
                           torch.ones_like(x, dtype=torch.bool))
        if step == 1:
            t_d, t_i = _merge(t_d, t_i, v, torch.where(s == NO_STEP, NONE,
                                                       t0 + s))
            continue
        best = []
        for r in range(3):
            live = s[..., r] != NO_STEP
            first = torch.where(live, s[..., r] * step, 0)
            d = torch.full(shape, math.inf)
            i = torch.full(shape, NONE, dtype=torch.int64)
            for u in range(step):
                c = staged[rows, first + u]               # (B, N, L, 3)
                d, i = _insert(d, i, k_fps.sqdist(pts, c), t0 + first + u,
                               live & (first + u < lim))
            best.append((d, i))
        d, i = _merge(*best[0], *best[1])
        d, i = _merge(d, i, *best[2])
        t_d, t_i = _merge(t_d, t_i, d, i)
    off = 1
    while off < lanes:
        partner = sub ^ off
        t_d, t_i = _merge(t_d, t_i, t_d[..., partner, :], t_i[..., partner, :])
        off *= 2
    assert (t_d == t_d[..., :1, :]).all() and (t_i == t_i[..., :1, :]).all()
    d, i = t_d[..., 0, :], t_i[..., 0, :]
    if m < 3:
        d = torch.cat([d[..., :m]] + [d[..., m - 1:m]] * (3 - m), -1)
        i = torch.cat([i[..., :m]] + [i[..., m - 1:m]] * (3 - m), -1)
    assert (i < m).all()
    return i.to(torch.int32), k_tnn.idw_weights(d)


_TNN_CLOUDS = [("random", 256, 64), ("lattice", 128, 64),
               ("duplicates", 128, 40), ("random", 64, 20),
               ("lattice", 64, 7), ("duplicates", 64, 5), ("random", 64, 3)]


@functools.lru_cache(maxsize=None)
def _tnn_case(kind, n, m):
    """Points, centres and the Pallas kernel's answer in interpret mode:
    random; the integer lattice against the centres of its cells (eight
    corners at one distance, many exact ties); centres in duplicate pairs in
    shuffled order (a higher lane may hold the lower index of a pair)."""
    rng = np.random.default_rng(n + 7 * m)
    if kind == "random":
        x = rng.standard_normal((2, n, 3)).astype(np.float32)
        c = rng.standard_normal((2, m, 3)).astype(np.float32)
    elif kind == "lattice":
        x = _fps_cloud("lattice", n) + np.float32(0.5)
        c = _fps_cloud("lattice", m)
    else:
        x = rng.standard_normal((2, n, 3)).astype(np.float32)
        c = _fps_cloud("duplicates", m)
    idx, w = three_nn_pallas(jnp.asarray(x), jnp.asarray(c), True)
    return (torch.from_numpy(x), torch.from_numpy(c), np.asarray(idx),
            torch.from_numpy(np.array(w)))


@pytest.mark.parametrize("kind,n,m", _TNN_CLOUDS, ids=lambda v: str(v))
@pytest.mark.parametrize("lanes", [None, 1, 2, 8, 32],
                         ids=["rule", "L1", "L2", "L8", "L32"])
@pytest.mark.parametrize("step", [None, 1, 4], ids=["rule", "U1", "U4"])
def test_three_nn_lane_merge(kind, n, m, lanes, step):
    """Exact against the plain version and the Pallas kernel in interpret
    mode; M no multiple of L U, and M < L (lanes with no centre)."""
    x, c, pallas_idx, pallas_w = _tnn_case(kind, n, m)
    idx, w = three_nn_lanes(x, c, lanes, step)
    pi, pw = k_tnn.three_nn_plain(x, c)
    assert torch.equal(idx, pi)
    assert _rel(w, pw) <= 1e-5
    np.testing.assert_array_equal(idx.numpy(), pallas_idx)
    assert _rel(w, pallas_w) <= 1e-5


@pytest.mark.parametrize("m,lanes,step", [(1, 4, 1), (2, 4, 1), (1, 32, 4),
                                          (2, 8, 4), (2, 1, 4)],
                         ids=lambda v: str(v))
def test_three_nn_lane_merge_fewer_than_three_centres(m, lanes, step):
    """M < 3: sentinels never win; the last centre found repeats."""
    x = torch.from_numpy(_cloud_np(64))
    c = torch.from_numpy(_cloud_np(m))
    idx, w = three_nn_lanes(x, c, lanes, step)
    pi, pw = k_tnn.three_nn_plain(x, c)
    assert torch.equal(idx, pi)
    assert _rel(w, pw) <= 1e-5


def _cloud_np(n):
    return np.random.default_rng(n).standard_normal((2, n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("lanes,step,tile", [(1, 4, 8), (2, 1, 16),
                                             (4, 4, 16), (2, 4, 24)],
                         ids=lambda v: str(v))
def test_three_nn_lane_merge_tiles(lanes, step, tile):
    """Several staged tiles, the last one ragged: the running triple
    carries across them."""
    x, c, _, _ = _tnn_case("lattice", 128, 64)
    c = c[:, :60].contiguous()
    idx, w = three_nn_lanes(x, c, lanes, step, tile)
    pi, pw = k_tnn.three_nn_plain(x, c)
    assert torch.equal(idx, pi)
    assert _rel(w, pw) <= 1e-5


@pytest.mark.parametrize("lanes,step,pair", [(8, 1, (1, 8)),
                                             (2, 4, (5, 8))],
                         ids=["U1", "U4"])
def test_three_nn_lowest_lane_is_not_lowest_index(lanes, step, pair):
    """Two centres on the query, the lower index on lane 1, the higher on
    lane 0. A first-lane pick would take the higher first; (d, index)
    order takes the lower."""
    x = torch.zeros(1, 1, 3)
    c = torch.full((1, 4 * lanes * step, 3), 5.0)
    c[0, list(pair)] = 0.0
    c[0, 3] = 1.0
    idx, _ = three_nn_lanes(x, c, lanes, step)
    assert idx[0, 0].tolist() == [pair[0], pair[1], 3]
    assert torch.equal(idx, k_tnn.three_nn_plain(x, c)[0])


@pytest.mark.parametrize("n,m,rule", [(4096, 1024, (1, 4)),
                                      (1024, 256, (4, 4)),
                                      (256, 64, (16, 1)), (64, 16, (16, 1)),
                                      (2048, 1024, (2, 4)), (64, 5, (8, 1)),
                                      (64, 2, (2, 1))],
                         ids=lambda v: str(v))
def test_three_nn_rule(n, m, rule):
    """The split at the five FP levels of the paths (B 8), and at M < L."""
    assert (k_tnn.lanes(8, n, m), k_tnn.step(m)) == rule


def interp_threads(idx, w, feats, threads=None, rows=None):
    """`interp_kernel` of csrc/interp.cu in PyTorch. With G groups of `vec`
    channels and H = min(G, T) of them a row in a block, block (x, b, z)
    covers rows x P R .. (x + 1) P R - 1, P = T // H rows a pass; thread
    t < P H takes group z T + t % H (z > 0 only where G > T) of rows
    x P R + t // H + q P, q < R. A thread loads its rows' three indices,
    clamped to [0, M), and weights, rounded to bf16, once; then the blend
    in float32 in k order, one rounding. -> (output, how many times each
    element was written)."""
    b, n, _ = idx.shape
    m, c = feats.shape[1:]
    threads = threads or k_interp.THREADS
    rows = rows or k_interp.ROWS
    vec = 8 if c % 8 == 0 else 1
    groups = c // vec
    row_groups = min(groups, threads)
    per_pass = threads // row_groups
    t = torch.arange(threads)
    blocks = -(-n // (per_pass * rows))
    r = (torch.arange(blocks)[:, None, None] * per_pass * rows
         + torch.arange(rows)[None, :, None] * per_pass
         + (t // row_groups)[None, None, :])           # (X, R, T)
    f = feats.reshape(b, m, groups, vec).float()
    out = torch.zeros(b, n, groups, vec, dtype=torch.bfloat16)
    hits = torch.zeros(b, n, groups, dtype=torch.int64)
    bi = torch.arange(b)[:, None, None]
    for z in range(-(-groups // threads)):             # spans of T groups
        j = (z * threads + t % row_groups).expand_as(r)
        live = (t // row_groups < per_pass) & (j < groups) & (r < n)
        rv, jv = r[live], j[live]
        ri = idx[:, rv].long().clamp(0, m - 1)         # (B, K, 3)
        wq = w[:, rv].to(torch.bfloat16).float()
        g = f[bi, ri, jv[None, :, None]]               # (B, K, 3, vec)
        acc = g[:, :, 0] * wq[..., 0:1]
        acc = acc + g[:, :, 1] * wq[..., 1:2]
        acc = acc + g[:, :, 2] * wq[..., 2:3]
        out[:, rv, jv] = acc.to(torch.bfloat16)
        hits.index_put_((bi[..., 0], rv[None], jv[None]),
                        torch.ones(b, rv.numel(), dtype=torch.int64),
                        accumulate=True)
    return out.reshape(b, n, c), hits


# (B, N, M, C): the path's group width with N no multiple of a block's
# rows, five groups (three idle threads a block), one channel a group
# (scalar) with a ragged tail, 200 groups over two spans of 128 threads,
# 33 groups, one group of 8 channels
_INTERP_CASES = [(2, 496, 128, 128), (2, 290, 128, 40), (1, 205, 128, 12),
                 (2, 64, 160, 200), (2, 256, 128, 264), (2, 512, 128, 8)]
# ... of which these are also held to the Pallas kernel (a compile each)
_INTERP_PALLAS = {(2, 496, 128, 128), (1, 205, 128, 12), (2, 256, 128, 264)}


@functools.lru_cache(maxsize=None)
def _interp_case(b, n, m, c):
    """Indices and weights from three-NN on random clouds, bf16 features
    and, for the cases of _INTERP_PALLAS, the Pallas kernel's answer in
    interpret mode."""
    rng = np.random.default_rng(b * n + m + c)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    ctr = rng.standard_normal((b, m, 3)).astype(np.float32)
    f = rng.standard_normal((b, m, c)).astype(np.float32)
    idx, w = k_tnn.three_nn_plain(torch.from_numpy(x), torch.from_numpy(ctr))
    fb = torch.from_numpy(f).to(torch.bfloat16)
    if (b, n, m, c) not in _INTERP_PALLAS:
        return idx, w, fb, None
    pallas = jax_interp_mm(jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(f).astype(jnp.bfloat16))
    return idx, w, fb, np.asarray(pallas.astype(jnp.float32))


@pytest.mark.parametrize("b,n,m,c", _INTERP_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("threads,rows", [(None, None), (256, 1), (512, 4)],
                         ids=["rule", "T256R1", "T512R4"])
def test_interp_thread_split(b, n, m, c, threads, rows):
    """Every output element written once, bit for bit the plain version,
    within one bf16 rounding of the Pallas kernel in interpret mode."""
    idx, w, f, pallas = _interp_case(b, n, m, c)
    out, hits = interp_threads(idx, w, f, threads, rows)
    assert (hits == 1).all()
    assert torch.equal(out, k_interp.interp_mm_plain(idx, w, f))
    if pallas is not None:
        scale = float(np.abs(pallas).max())
        np.testing.assert_allclose(out.float().numpy(), pallas, rtol=8e-3,
                                   atol=8e-3 * scale)


def test_interp_clamps_indices():
    """An index outside [0, M) reads the nearest row of F."""
    idx, w, f, _ = _interp_case(2, 496, 128, 128)
    bad = idx.clone()
    bad[:, ::5, 0] = -3
    bad[:, 1::7, 2] = 128 + 9
    out, _ = interp_threads(bad, w, f)
    assert torch.equal(out, k_interp.interp_mm_plain(bad.clamp(0, 127), w,
                                                     f))


@pytest.mark.parametrize("c", [128, 256, 8, 64])
def test_interp_warp_rows(c):
    """At the kernel's block, the lanes of a warp take 32 / G consecutive
    rows, whole, with groups fastest: one store instruction writes one
    contiguous span of the output."""
    groups = c // 8
    per_pass = k_interp.THREADS // groups
    for warp in range(k_interp.THREADS // 32):
        lane = torch.arange(32) + 32 * warp
        for q in range(k_interp.ROWS):
            r = lane // groups + q * per_pass
            flat = r * groups + lane % groups        # 16-byte slots
            assert torch.equal(flat, flat[0] + torch.arange(32))
