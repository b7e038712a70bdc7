"""`bdm_tpu_torch.parallel.point_sharded` against
`bdm_tpu.parallel.point_sharded` on `get_mesh(2)` / `get_mesh(4)` of the
8 virtual CPU devices, with the cases of tests/test_point_sharded.py
(duplicates, U larger than a shard, no hits) and a lone hit at index 0.

The port runs on four gloo ranks spawned once for the file
(`tests/torch_ranks.py::point_rank`, one thread each): the world group for
P = 4, each half of it for P = 2. Indices exactly; floats as the JAX tests
hold them, against the JAX function within the port's float32 tolerance
across the two frameworks (1e-5 of the largest entry, as
tests/test_torch_ops.py). The tiny PVCNN2 sharded over two ranks against
the port's unsharded one: the forward within rtol 1e-4 / atol 5e-5, every
parameter gradient within rtol 2e-4 / atol 1e-5 (the JAX tests'); the
sharded GroupNorm, a 2 x 2 data x point grid and PC2's denoise (its
projection's z-buffer taken over the whole cloud) likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu.parallel import point_sharded as J
from bdm_tpu.parallel.mesh import get_mesh
from bdm_tpu_torch import ops
from bdm_tpu_torch.models import PVCNN2
from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
from tests import torch_ranks as R

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

F32 = 1e-5


def cloud(seed, shape, scale=1.0):
    return R.rng_cloud(seed, shape, scale)


def _duplicates():
    base = cloud(2, (1, 32, 3))
    return torch.cat([base, base], dim=1)


def _spaced():
    """Points (n, 0, 0): a radius of 0.5 holds one point at most."""
    pts = torch.zeros(1, 64, 3)
    pts[0, :, 0] = torch.arange(64.0)
    return pts


CENTRES_SPACED = torch.tensor([[[0.0, 0, 0], [40.0, 0, 0], [0.4, 0, 0],
                                [100.0, 0, 0]]])

# name -> (function, P, [(argument, point-sharded?)], kind of each output)
CASES = {
    "fps_random": ("fps_point_sharded", 4,
                   [(cloud(0, (2, 256, 3)), True), (33, False)], "rep"),
    "fps_duplicates": ("fps_point_sharded", 4,
                       [(_duplicates(), True), (16, False)], "rep"),
    "fps_gather": ("fps_gather_point_sharded", 4,
                   [(cloud(3, (2, 128, 3)), True), (17, False)], "rep"),
    "gather": ("gather_point_sharded", 4,
               [(cloud(4, (2, 128, 7)), True),
                (torch.from_numpy(np.random.default_rng(5).integers(
                    0, 128, (2, 17)).astype(np.int32)), False)], "rep"),
    "ball_random": ("ball_query_point_sharded", 4,
                    [(cloud(6, (2, 16, 3)), False),
                     (cloud(7, (2, 256, 3)), True), (0.7, False),
                     (9, False)], "rep"),
    "ball_u_exceeds_shard": ("ball_query_point_sharded", 4,   # shard 8 < U
                             [(cloud(8, (1, 8, 3)), False),
                              (cloud(9, (1, 32, 3)), True), (1.5, False),
                              (12, False)], "rep"),
    "ball_no_hits": ("ball_query_point_sharded", 2,
                     [(torch.full((1, 4, 3), 100.0), False),
                      (torch.ones(1, 64, 3), True), (0.5, False),
                      (5, False)], "rep"),
    "ball_hit_at_zero_alone": ("ball_query_point_sharded", 2,
                               [(CENTRES_SPACED, False), (_spaced(), True),
                                (0.5, False), (4, False)], "rep"),
    "three_nn": ("three_nn_point_sharded", 2,
                 [(cloud(10, (2, 128, 3)), True),
                  (cloud(11, (2, 24, 3)), False)], ("shard", "shard")),
    "interpolate": ("three_nn_interpolate_point_sharded", 2,
                    [(cloud(10, (2, 128, 3)), True),
                     (cloud(11, (2, 24, 3)), False),
                     (cloud(12, (2, 24, 5)), False)], "shard"),
    "grouping": ("grouping_point_sharded", 4,
                 [(cloud(13, (2, 128, 7)), True),
                  (torch.from_numpy(np.random.default_rng(14).integers(
                      0, 128, (2, 16, 4)).astype(np.int32)), False)], "rep"),
    "voxel_grid": ("voxel_grid_point_sharded", 2,
                   [(cloud(15, (2, 256, 5)), True),
                    (cloud(16, (2, 256, 3)), True), (4, False)],
                   ("rep", "shard")),
    "devoxelize": ("devoxelize_point_sharded", 2,
                   [(cloud(17, (2, 4, 4, 4, 5)), False),
                    (torch.from_numpy(np.random.default_rng(18).uniform(
                        0, 3, (2, 256, 3)).astype(np.float32)), True)],
                   "shard"),
    "p2v2p": ("point_to_voxel_to_point_sharded", 2,
              [(cloud(15, (2, 256, 5)), True),
               (cloud(16, (2, 256, 3)), True), (4, False)], "shard"),
}
SP_ACTIVE = {"none": (1, 4096, 2048), "two": (2, 4096, 2048),
             "few": (2, 1024, 2048), "odd": (2, 2049, 2048),
             "four": (4, 256, 64)}

TINY_PVCNN = dict(out_channels=3, embed_dim=8, extra_feature_channels=5,
                  sa_blocks=R.TINY_SA, fp_blocks=R.TINY_FP,
                  classifier_init_scale=None)
PC2_CFG = dict(image_size=16, image_feature_model="identity",
               raster_point_radius=0.3, point_cloud_model_embed_dim=8)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    model = PVCNN2(**TINY_PVCNN)
    model.reset_parameters(0)
    pc2 = PC2Model(ProjectionConfig(**PC2_CFG), R.TINY_SA, R.TINY_FP,
                   device="cpu")
    pc2.reset_parameters(1)
    with torch.no_grad():       # a visible head
        head = pc2.backbone.classifier[2].weight
        head.copy_(cloud(19, tuple(head.shape), 0.1))
    rng = np.random.default_rng(20)
    inputs = {
        "cases": {k: {"fn": fn, "p": p, "args": args}
                  for k, (fn, p, args, _) in CASES.items()},
        "sp_active": SP_ACTIVE,
        "pvcnn_common": TINY_PVCNN,
        "pvcnn_state": model.state_dict(),
        "pvcnn_x": cloud(21, (2, 256, 8)),
        "pvcnn_t": torch.tensor([3, 7]),
        "pvcnn_grad_x": cloud(22, (2, 128, 8)),
        "pvcnn_grad_tgt": cloud(23, (2, 128, 3)),
        "gn_x": cloud(24, (2, 64, 16)),
        "gn_dy": cloud(25, (2, 64, 16)),
        "gn_weight": cloud(26, (16,)),
        "gn_bias": cloud(27, (16,)),
        "pc2_cfg": PC2_CFG,
        "pc2_state": pc2.state_dict(),
        "pc2_image": torch.from_numpy(rng.uniform(
            0, 1, (2, 16, 16, 3)).astype(np.float32)),
        "pc2_camera": dict(R=torch.eye(3).expand(2, 3, 3).clone(),
                           T=torch.tensor([[0.0, 0.0, 2.0]] * 2),
                           focal_length=torch.full((2, 2), 2.0),
                           principal_point=torch.zeros(2, 2)),
        "pc2_x": cloud(28, (2, 64, 3), 0.3),
        "pc2_t": torch.tensor([5, 400]),
    }
    return inputs, R.run(R.point_rank, 4, tmp_path_factory.mktemp("sp"),
                         inputs)


def _assemble(outs, p, kind):
    """The whole result from ranks 0..p-1: shards joined on the point
    axis; a replicated result equal on every rank of the group."""
    if isinstance(kind, tuple):
        return tuple(_assemble([o[i] for o in outs], p, k)
                     for i, k in enumerate(kind))
    if kind == "shard":
        return torch.cat(outs[:p], dim=1)
    for o in outs[1:p]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _port(ranks, name):
    _, outs = ranks
    _, p, _, kind = CASES[name]
    return _assemble([o[name] for o in outs], p, kind)


def _jax(name):
    """The JAX function on the case's arrays, under one `jax.jit` (the
    other arguments are static)."""
    fn, p, args, _ = CASES[name]
    arrays = [jnp.asarray(a.numpy()) for a, _ in args
              if isinstance(a, torch.Tensor)]

    def call(*arrays):
        it = iter(arrays)
        jargs = [next(it) if isinstance(a, torch.Tensor) else a
                 for a, _ in args]
        if fn == "point_to_voxel_to_point_sharded":
            jargs.insert(3, lambda grid: jnp.tanh(grid) + grid * 0.5)
        return getattr(J, fn)(*jargs, get_mesh(p, "sp"))

    return jax.jit(call)(*arrays)


def _close(got, want, rtol=F32):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("name", ["fps_random", "fps_duplicates"])
def test_fps_matches_jax(ranks, name):
    got = _port(ranks, name)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax(name)))
    args = CASES[name][2]
    want = ops.furthest_point_sample(args[0][0], args[1][0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["fps_gather", "gather"])
def test_gathers_match_jax(ranks, name):
    """Exact: each row comes from the one rank that owns it."""
    np.testing.assert_array_equal(_port(ranks, name).numpy(),
                                  np.asarray(_jax(name)))


@pytest.mark.parametrize("name", ["ball_random", "ball_u_exceeds_shard",
                                  "ball_no_hits", "ball_hit_at_zero_alone"])
def test_ball_query_matches_jax(ranks, name):
    got = _port(ranks, name)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax(name)))
    (cen, _), (pts, _), (r, _), (u, _) = CASES[name][2]
    assert torch.equal(got, ops.ball_query(cen, pts, r, u))
    if name == "ball_no_hits":
        assert not got.any()
    if name == "ball_hit_at_zero_alone":
        assert got.tolist() == [[[0] * 4, [40] * 4, [0] * 4, [0] * 4]]


def test_three_nn_and_interpolation_match_jax(ranks):
    idx, w = _port(ranks, "three_nn")
    jidx, jw = _jax("three_nn")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w.numpy(), jw)
    (pts, _), (cen, _) = CASES["three_nn"][2]
    uidx, uw = ops.three_nn(pts, cen)
    assert torch.equal(idx, uidx) and torch.equal(w, uw)
    _close(_port(ranks, "interpolate").numpy(), _jax("interpolate"))


def test_grouping_matches_jax(ranks):
    np.testing.assert_array_equal(_port(ranks, "grouping").numpy(),
                                  np.asarray(_jax("grouping")))


def test_voxel_grid_and_devoxelization_match_jax(ranks):
    grid, norm_coords = _port(ranks, "voxel_grid")
    jgrid, jnorm = _jax("voxel_grid")
    _close(grid.numpy(), jgrid)
    _close(norm_coords.numpy(), jnorm)
    _close(_port(ranks, "devoxelize").numpy(), _jax("devoxelize"))


def test_point_to_voxel_to_point_matches_jax(ranks):
    _close(_port(ranks, "p2v2p").numpy(), _jax("p2v2p"))


def test_sp_active_matches_jax(ranks):
    _, outs = ranks
    for k, (p, n, m) in SP_ACTIVE.items():
        assert outs[0]["sp_active"][k] == J.sp_active(get_mesh(p, "sp"), n,
                                                      m), k


def test_pvcnn2_forward_matches_unsharded(ranks):
    _, outs = ranks
    got = torch.cat([o["pvcnn_got"] for o in outs[:2]], dim=1)
    np.testing.assert_allclose(got.numpy(), outs[0]["pvcnn_want"].numpy(),
                               rtol=1e-4, atol=5e-5)


def test_pvcnn2_gradients_match_unsharded(ranks):
    """The sum of the ranks' parameter gradients, each rank's loss its part
    of the whole mean, is the unsharded gradient of every parameter."""
    _, outs = ranks
    want, got = outs[0]["grad_want"], outs[0]["grad_got"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=k)


def test_group_norm_takes_whole_statistics(ranks):
    """Four shards of (2, 64, 16) normalised with the statistics of the
    whole, and the gradients of the input and the scale through them."""
    from bdm_tpu_torch.models.layers import GroupNormCL
    inputs, outs = ranks
    gn = GroupNormCL(4, 16)
    with torch.no_grad():
        gn.weight.copy_(inputs["gn_weight"])
        gn.bias.copy_(inputs["gn_bias"])
    x = inputs["gn_x"].clone().requires_grad_(True)
    y = gn(x)
    (y * inputs["gn_dy"]).sum().backward()
    got_y = torch.cat([o["gn"][0] for o in outs], dim=1)
    got_dx = torch.cat([o["gn"][1] for o in outs], dim=1)
    _close(got_y.numpy(), y.detach().numpy())
    _close(got_dx.numpy(), x.grad.numpy(), 1e-4)
    _close(outs[0]["gn"][2].numpy(), gn.weight.grad.numpy())


def test_pvcnn2_data_times_point_parallel(ranks):
    """A 2 x 2 grid, the counterpart of the JAX (dp=2, sp=2) mesh: rank
    2d + s holds batch row d and point half s."""
    _, outs = ranks
    got = torch.cat([torch.cat([outs[2 * d]["dp_sp"],
                                outs[2 * d + 1]["dp_sp"]], dim=1)
                     for d in range(2)], dim=0)
    np.testing.assert_allclose(got.numpy(), outs[0]["pvcnn_want"].numpy(),
                               rtol=1e-4, atol=5e-5)


def test_pc2_denoise_point_sharded(ranks):
    """PC2's projection competes every point with the whole cloud (a
    z-buffer MIN over the ranks), so the sharded denoise is the unsharded
    one."""
    _, outs = ranks
    got = torch.cat([o["denoise_got"] for o in outs[:2]], dim=1)
    np.testing.assert_allclose(got.numpy(), outs[0]["denoise_want"].numpy(),
                               rtol=1e-4, atol=5e-5)
