"""The port's data layer against `bdm_tpu.data` on the same fake trees.

Tolerances: none. The cameras are built in float64 NumPy on both sides and
rounded once to float32, so they are bit-equal; R2N2's one-time subsample
draws from global `np.random` on both sides after the same
`np.random.seed`, so points, images, cameras and names are exactly equal.
"""

import sys

import numpy as np
import pytest
import torch

import bdm_tpu.conditioning.cameras as JC
from bdm_tpu.config import parse_cli as jax_parse_cli
from bdm_tpu.data import DataLoader as JaxLoader
from bdm_tpu.data import Pix3DDataset as JaxPix3D
from bdm_tpu.data import ShapeNetR2N2Dataset as JaxR2N2
from bdm_tpu.data import SyntheticDataset as JaxSynthetic
from bdm_tpu.data import get_dataset as jax_get_dataset
from bdm_tpu.data.loader import model_batch as jax_model_batch
from bdm_tpu.data.preprocess_pix3d import main as jax_preprocess_main
from bdm_tpu.data.preprocess_pix3d import \
    sample_points_from_mesh as jax_sample_mesh
import bdm_tpu_torch.conditioning.cameras as TC
from bdm_tpu_torch.config import parse_cli
from bdm_tpu_torch.data import (DataLoader, Pix3DDataset, ShapeNetR2N2Dataset,
                                SyntheticDataset, batch_to_device,
                                get_dataset, model_batch)
from bdm_tpu_torch.data.preprocess_pix3d import main as preprocess_main
from bdm_tpu_torch.data.preprocess_pix3d import (load_obj_mesh,
                                                 sample_points_from_mesh)
from tests.test_data import fake_pix3d, fake_r2n2  # noqa: F401 (fixtures)
from tests.test_torch_config import jax_pointio_private  # noqa: F401

# tiny tensors: one intra-op thread is faster than many, and six pytest
# workers on the host's cores do not oversubscribe them
torch.set_num_threads(1)

CAM_FIELDS = ("R", "T", "focal_length", "principal_point")


def assert_camera_equal(port, jax_cam):
    for f in CAM_FIELDS:
        got, want = getattr(port, f), np.asarray(getattr(jax_cam, f))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def assert_sample_equal(port, jax_sample):
    assert port.keys() == jax_sample.keys()
    for k, v in jax_sample.items():
        if k == "camera":
            assert_camera_equal(port[k], v)
        elif isinstance(v, np.ndarray):
            assert port[k].dtype == v.dtype, k
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        else:
            assert port[k] == v, k


def assert_datasets_equal(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    for i in range(len(port)):
        assert_sample_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("view", [(0.0, 25.0, 0.7), (137.5, -12.0, 1.3),
                                  (359.0, 89.0, 0.05)])
def test_camera_helpers_bit_equal(view):
    azim, elev, dist = view
    rt = TC.compute_extrinsic_matrix(azim, elev, dist * TC.MAX_CAMERA_DISTANCE)
    jrt = JC.compute_extrinsic_matrix(azim, elev,
                                      dist * JC.MAX_CAMERA_DISTANCE)
    np.testing.assert_array_equal(rt, jrt)
    rs, ts = TC.compute_camera_calibration(rt)
    jrs, jts = JC.compute_camera_calibration(jrt)
    np.testing.assert_array_equal(rs, jrs)
    np.testing.assert_array_equal(ts, jts)
    mean = np.array([0.01, -0.2, 0.3])
    assert_camera_equal(
        TC.camera_from_r2n2(rs.astype(np.float32), ts.astype(np.float32),
                            mean, 0.37),
        JC.camera_from_r2n2(jrs.astype(np.float32), jts.astype(np.float32),
                            mean, 0.37))
    r = rs * 1.7
    screen = (r, ts, (210.3, 199.9), (100.25, 123.5), 224)
    assert_camera_equal(TC.camera_from_screen(*screen),
                        JC.camera_from_screen(*screen))
    assert (TC.R2N2_FOCAL, TC.MAX_CAMERA_DISTANCE) == (
        JC.R2N2_FOCAL, JC.MAX_CAMERA_DISTANCE)


def test_stack_cameras_equal_jax():
    views = [(30.0 * i, 10.0 * i, 0.5 + 0.1 * i) for i in range(3)]
    cams, jcams = [], []
    for azim, elev, dist in views:
        rs, ts = TC.compute_camera_calibration(
            TC.compute_extrinsic_matrix(azim, elev, dist))
        cams.append(TC.camera_from_r2n2(rs, ts, np.zeros(3), 1.0))
        jcams.append(JC.camera_from_r2n2(rs, ts, np.zeros(3), 1.0))
    stacked = TC.stack_cameras(cams)
    assert stacked.R.shape == (3, 3, 3)
    assert_camera_equal(stacked, JC.stack_cameras(jcams))


R2N2_CASES = {
    "train": dict(split="train"),
    "test": dict(split="test"),
    "subset": dict(split="train", subset_ratio=2 / 3),
    "start_subset": dict(split="train", start_ratio=1 / 3, subset_ratio=1.0),
    "per_shape": dict(split="train", normalize_per_shape=True),
    "parallel": dict(split="train", build_workers=3),
}


@pytest.mark.parametrize("case", list(R2N2_CASES))
def test_r2n2_equals_jax(fake_r2n2, case):  # noqa: F811
    root, r2n2 = fake_r2n2
    kw = dict(root_dir=root, r2n2_dir=r2n2, max_points=96, image_size=24,
              **R2N2_CASES[case])
    np.random.seed(11)
    port = ShapeNetR2N2Dataset(**kw)
    np.random.seed(11)
    want = JaxR2N2(**kw)
    assert_datasets_equal(port, want)
    np.testing.assert_array_equal(port.points_mean, want.points_mean)
    np.testing.assert_array_equal(port.points_std, want.points_std)


@pytest.mark.parametrize("processed", [False, True],
                         ids=["raw", "processed"])
def test_pix3d_equals_jax(fake_pix3d, processed, monkeypatch):  # noqa: F811
    if processed:
        # the port's preprocessing writes the tree both read; the JAX one
        # writes the same files
        out = fake_pix3d.replace("pix3d", "pix3d_processed")
        argv = ["preprocess", "--root", fake_pix3d, "--num_points", "64",
                "--image_size", "32"]
        monkeypatch.setattr(sys, "argv", argv)
        jax_preprocess_main()
        model = f"{out}/model/chair/m1/model.obj"
        jax_model = open(model).read()
        jax_img = open(f"{out}/img/chair/0000.png", "rb").read()
        preprocess_main()
        assert open(model).read() == jax_model
        assert open(f"{out}/img/chair/0000.png", "rb").read() == jax_img
    for split in ("train", "test"):
        kw = dict(root_dir=fake_pix3d, split=split, max_points=3,
                  image_size=32, processed=processed, seed=5)
        assert_datasets_equal(Pix3DDataset(**kw), JaxPix3D(**kw))


def test_mesh_sampling_equals_jax(fake_pix3d):  # noqa: F811
    verts, faces = load_obj_mesh(f"{fake_pix3d}/model/chair/m1/model.obj")
    assert faces.shape == (4, 3)
    got = sample_points_from_mesh(verts, faces, 50,
                                  np.random.default_rng(3))
    want = jax_sample_mesh(verts, faces, 50, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_synthetic_equals_jax():
    for seed in (0, 1):
        port = SyntheticDataset(num_samples=3, max_points=16, image_size=8,
                                seed=seed)
        assert_datasets_equal(port, JaxSynthetic(
            num_samples=3, max_points=16, image_size=8, seed=seed))


def assert_batch_equal(port, jax_batch):
    assert port.keys() == jax_batch.keys()
    for k, v in jax_batch.items():
        if k == "camera":
            assert_camera_equal(port[k], v)
        elif isinstance(v, list):
            assert port[k] == v
        else:
            assert isinstance(port[k], torch.Tensor)
            assert port[k].dtype == torch.float32
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("shuffle,drop_last,workers",
                         [(True, True, 0), (False, False, 2)])
def test_loader_order_and_batches_equal_jax(shuffle, drop_last, workers):
    kw = dict(num_samples=7, max_points=8, image_size=4)
    lk = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=4,
              num_workers=workers)
    port = DataLoader(SyntheticDataset(**kw), **lk)
    want = JaxLoader(JaxSynthetic(**kw), **lk)
    assert len(port) == len(want)
    for _ in range(2):   # two epochs: the shuffle's generator advances
        got, exp = list(port), list(want)
        assert len(got) == len(exp) == len(port)
        for a, b in zip(got, exp):
            assert_batch_equal(a, b)
            assert a["camera"].R.shape == (a["points"].shape[0], 3, 3)
    it, jit = port.infinite(), want.infinite()
    for _ in range(5):
        assert_batch_equal(next(it), next(jit))
    b = got[0]
    mb = model_batch(b)
    assert set(mb) == set(jax_model_batch(exp[0])) == {"points", "image",
                                                       "camera"}
    moved = batch_to_device(b, "cpu")
    assert set(moved) == set(mb)
    assert moved["camera"].R.dtype == torch.float32


@pytest.mark.parametrize("kind", ["synthetic", "shapenet_r2n2", "pix3d"])
def test_get_dataset_equals_jax(kind, request):
    if kind == "shapenet_r2n2":
        root, r2n2 = request.getfixturevalue("fake_r2n2")
        extra = [f"dataset.root={root}", f"dataset.r2n2_dir={r2n2}"]
    elif kind == "pix3d":
        extra = [f"dataset.root={request.getfixturevalue('fake_pix3d')}",
                 "dataset.processed=false"]
    else:
        extra = []
    for job in ("train", "sample"):
        argv = [f"dataset={kind}", "dataset.max_points=16",
                "dataset.image_size=8", "dataloader.batch_size=2",
                "dataloader.num_workers=0", f"run.job={job}"] + extra
        np.random.seed(3)
        port = get_dataset(parse_cli(argv))
        np.random.seed(3)
        want = jax_get_dataset(jax_parse_cli(argv))
        assert (port[0] is None) == (want[0] is None) == (
            job == "sample" and kind != "synthetic")
        assert port[1] is port[2]
        for a, b in zip(port, want):
            if a is None:
                continue
            assert len(a) == len(b) and a.batch_size == b.batch_size
            for x, y in zip(a, b):
                assert_batch_equal(x, y)
