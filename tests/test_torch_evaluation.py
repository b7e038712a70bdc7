"""The port's evaluation against `bdm_tpu.evaluation` on the same clouds.

Tolerances: Chamfer within rtol 1e-5 and Sinkhorn EMD within rtol 1e-4
(the same |a|^2 + |b|^2 - 2ab formula; the cross term's three products may
be summed in another order than XLA's dot, and logsumexp differs by a few
ulps); F1 exact on the reference's threshold cases and within 1/N on
random clouds (a point at the threshold may fall either side by one ulp);
the generative metrics within rtol 1e-5 (their argmins agree exactly on
these clouds); `evaluate_dirs` equal to JAX's within the same tolerances,
with the same NaN names and the same missing-gt warning. The sharded
Chamfer distance on two gloo ranks (`tests/torch_ranks.py::chamfer_rank`)
within rtol 1e-5 of the dense one and of JAX's on `get_mesh(2)`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_tpu.evaluation import gen_metrics as JG
from bdm_tpu.evaluation import metrics as JM
from bdm_tpu.evaluation.cli import evaluate_dirs as jax_evaluate_dirs
from bdm_tpu.evaluation.cli import main as jax_eval_main
from bdm_tpu_torch.evaluation import gen_metrics as G
from bdm_tpu_torch.evaluation import metrics as M
from bdm_tpu_torch.evaluation.cli import evaluate_dirs
from bdm_tpu_torch.evaluation.cli import main as eval_main
from bdm_tpu_torch.utils import write_ply
from tests import torch_ranks as R

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)


def clouds(seed, b=3, n=200, m=170, scale=0.3):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    c = (rng.standard_normal((b, m, 3)) * scale + 0.05).astype(np.float32)
    return a, c


def t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("recenter", [True, False])
def test_chamfer_and_min_sqdist_match_jax(recenter):
    a, b = clouds(0)
    got = M.chamfer_distance(t(a), t(b), recenter=recenter).numpy()
    want = np.asarray(JM.chamfer_distance(jnp.asarray(a), jnp.asarray(b),
                                          recenter=recenter))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(M.pairwise_min_sqdist(t(a), t(b)),
                    JM.pairwise_min_sqdist(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    same = M.chamfer_distance(t(a), t(a)).numpy()
    assert (same < 1e-6).all()


def test_fscore_threshold_semantics():
    """One point at squared distance 0.009 (inside) and 0.011 (outside):
    exactly 1 and 0, as `tests/test_evaluation.py` holds the JAX one."""
    a = np.zeros((1, 1, 3), dtype=np.float32)
    for sq, want in ((0.009, 1.0), (0.011, 0.0)):
        b = np.array([[[np.sqrt(sq), 0, 0]]], dtype=np.float32)
        f1, p, r = M.fscore(t(a), t(b), recenter=False)
        jf1, _, _ = JM.fscore(jnp.asarray(a), jnp.asarray(b),
                              recenter=False)
        assert float(f1[0]) == float(jf1[0]) == want


@pytest.mark.parametrize("threshold", [0.01, 0.05])
def test_fscore_random_within_one_point(threshold):
    a, b = clouds(1, n=256, m=256, scale=0.2)
    got = M.fscore(t(a), t(b), threshold=threshold)
    want = JM.fscore(jnp.asarray(a), jnp.asarray(b), threshold=threshold)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1.0 / 256 + 1e-7)
    assert 0 < float(got[0].mean()) < 1


@pytest.mark.parametrize("recenter", [False, True])
def test_emd_sinkhorn_matches_jax(recenter):
    a, b = clouds(2, n=64, m=48)
    got = M.emd_sinkhorn(t(a), t(b), recenter=recenter).numpy()
    want = np.asarray(JM.emd_sinkhorn(jnp.asarray(a), jnp.asarray(b),
                                      recenter=recenter))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_emd_identity_and_shift():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((1, 64, 3)).astype(np.float32)
    assert float(M.emd_sinkhorn(t(a), t(a[:, rng.permutation(64)]))) < 0.02
    shifted = float(M.emd_sinkhorn(t(a), t(a + np.float32([0.5, 0, 0]))))
    np.testing.assert_allclose(shifted, 0.5, atol=0.05)


def test_generative_metrics_match_jax():
    sample, _ = clouds(3, b=6, n=64)
    ref, _ = clouds(4, b=5, n=64)
    ref = ref * np.float32(1.1)
    d = G.pairwise_chamfer_matrix(t(sample), t(ref))
    jd = JG.pairwise_chamfer_matrix(jnp.asarray(sample), jnp.asarray(ref))
    assert d.shape == (6, 5) and d.dtype == np.float32
    np.testing.assert_allclose(d, jd, rtol=1e-5)
    np.testing.assert_allclose(
        G.mmd_cov(t(sample), t(ref)),
        JG.mmd_cov(jnp.asarray(sample), jnp.asarray(ref)), rtol=1e-5)
    assert G.one_nna(t(sample), t(ref)) == JG.one_nna(
        jnp.asarray(sample), jnp.asarray(ref))
    np.testing.assert_allclose(
        G.jsd_between_point_cloud_sets(t(sample), t(ref)),
        JG.jsd_between_point_cloud_sets(sample, ref), rtol=1e-12)


@pytest.fixture
def ply_dirs(tmp_path):
    """pred/gt .ply pairs: 5 matched (one NaN cloud), one pred without a
    gt, and an unrelated file."""
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    a, b = clouds(5, b=6, n=128, m=128)
    for i in range(6):
        p = a[i].copy()
        if i == 2:
            p[7, 1] = np.nan
        write_ply(str(pred / f"s{i:02d}.ply"), p)
        if i != 4:
            write_ply(str(gt / f"s{i:02d}.ply"), b[i])
    (pred / "notes.txt").write_text("not a cloud")
    return str(pred), str(gt)


@pytest.mark.parametrize("metric", ["cd", "f1", "emd"])
def test_evaluate_dirs_matches_jax(ply_dirs, metric):
    pred, gt = ply_dirs
    values, nans = evaluate_dirs(pred, gt, metric, batch_size=2,
                                 device="cpu")
    want, want_nans = jax_evaluate_dirs(pred, gt, metric, batch_size=2)
    # a NaN cloud has NaN distances: CD and EMD are NaN, F1 is 0 (no
    # distance is under the threshold)
    assert nans == want_nans == ([] if metric == "f1" else ["s02.ply"])
    assert len(values) == len(want) == 5 - len(nans)
    tol = dict(cd=dict(rtol=1e-5), f1=dict(atol=1 / 128 + 1e-7),
               emd=dict(rtol=1e-4))[metric]
    np.testing.assert_allclose(values, want, **tol)


def test_eval_cli_prints_what_jax_prints(ply_dirs, capsys):
    pred, gt = ply_dirs
    eval_main(["--pred_dir", pred, "--gt_dir", gt, "--device", "cpu",
               "--batch_size", "3"])
    ours = capsys.readouterr().out.splitlines()
    jax_eval_main(["--pred_dir", pred, "--gt_dir", gt, "--batch_size", "3"])
    theirs = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in ours] == [
        line.split(":")[0] for line in theirs]
    assert ours[0].startswith("WARNING: 1 pred files without gt match")
    assert any(line.startswith("Chamfer-L2 x1000: ") for line in ours)
    assert any(line.startswith("F1@0.01: ") for line in ours)
    assert "  NaN results: ['s02.ply']" in ours
    assert len(os.listdir(pred)) == 7


@pytest.fixture(scope="module")
def sharded_chamfer(tmp_path_factory):
    """pred's 256 points split over two ranks, gt whole on each."""
    a, b = clouds(9, b=2, n=256, m=170)
    outs = R.run(R.chamfer_rank, 2, tmp_path_factory.mktemp("cd"),
                 {"pred": t(a), "gt": t(b)})
    for o in outs[1:]:
        assert all(torch.equal(o[r], outs[0][r]) for r in (True, False))
    return a, b, outs[0]


@pytest.mark.parametrize("recenter", [True, False])
def test_chamfer_sharded_equals_dense(sharded_chamfer, recenter):
    a, b, got = sharded_chamfer
    np.testing.assert_allclose(
        got[recenter].numpy(),
        M.chamfer_distance(t(a), t(b), recenter=recenter).numpy(), rtol=1e-5)


def test_chamfer_sharded_matches_jax(sharded_chamfer):
    from bdm_tpu.parallel import get_mesh
    a, b, got = sharded_chamfer
    want = JM.chamfer_distance_sharded(jnp.asarray(a), jnp.asarray(b),
                                       get_mesh(2))
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want),
                               rtol=1e-5)
