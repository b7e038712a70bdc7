"""The port's config, PLY IO and native point reader against `bdm_tpu`'s.

Tolerances: none. The config is a copy (equal dicts), `write_ply` writes the
same bytes, and the point reader (native and its NumPy fallback) returns
the same arrays as the JAX package's on the same files and seeds.
"""

import numpy as np
import pytest

import bdm_tpu.native.pointio as jax_pointio
from bdm_tpu.config import parse_cli as jax_parse_cli
from bdm_tpu.config.structured import ProjectConfig as JaxProjectConfig
from bdm_tpu.config.structured import load_config as jax_load_config
from bdm_tpu.config.structured import to_dict as jax_to_dict
from bdm_tpu.utils import read_ply as jax_read_ply
from bdm_tpu.utils import write_ply as jax_write_ply
import bdm_tpu_torch.native.pointio as pointio
from bdm_tpu_torch.config import ProjectConfig, parse_cli
from bdm_tpu_torch.config.structured import load_config, to_dict
from bdm_tpu_torch.utils import read_ply, write_ply

ARGVS = [
    [],
    ["run.job=sample", "run.num_inference_steps=64",
     "dataset.subset_ratio=0.1", "dataset.max_points=4096",
     "aux_run.milestones=[1000,968,936,872,128,64,32,0]",
     "aux_run.roll_step=16", "run.manual_seed=null", "logging.wandb=false"],
    ["dataset=pix3d", "scheduler=fusion", "run.max_fusion_steps=20000"],
    ["dataset=synthetic", "scheduler=linear", "optimizer=adadelta",
     "model=diffrec", "scheduler=constant"],
    # interpolation is resolved after every override, in any order
    ["dataset.image_size=128", "dataset.scale_factor=2.0",
     "run.max_steps=77", "model.use_mask=true"],
    ["run.max_steps=5", "dataset.image_size=96", "model.image_size=64"],
    # coercion: ints, floats, bools, null, lists, JSON dicts, strings
    ["run.cpu=True", "run.mixed_precision=no", "optimizer.lr=3e-4",
     "optimizer.kwargs={\"betas\": [0.9, 0.99]}", "run.name=my run",
     "checkpoint.resume=/x/checkpoint-latest.pt",
     "optimizer.clip_grad_norm=None", "dataset.restrict_model_ids=[\"a\"]"],
]


def test_default_config_dict_equals_jax():
    assert to_dict(ProjectConfig()) == jax_to_dict(JaxProjectConfig())
    cfg = parse_cli([])
    assert cfg.run.mixed_precision == "bf16"
    assert cfg.dataset.max_points == 16_384


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_cli_equals_jax(argv):
    assert to_dict(parse_cli(argv)) == jax_to_dict(jax_parse_cli(argv))


def test_load_config_equals_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text('{"run": {"max_steps": 9, "name": "x"}, '
                    '"dataset": {"image_size": 64}}')
    assert to_dict(load_config(str(path))) == jax_to_dict(
        jax_load_config(str(path)))


@pytest.mark.parametrize("argv,err", [
    (["dataset.nonexistent=1"], KeyError),
    (["dataset=not_a_dataset"], ValueError),
    (["run.job"], ValueError),
])
def test_unknown_keys_raise(argv, err):
    with pytest.raises(err):
        parse_cli(argv)
    with pytest.raises(err):
        jax_parse_cli(argv)


def test_ply_roundtrip_and_bytes_equal_jax(tmp_path, rng):
    pts = rng.standard_normal((100, 3))     # float64: both round to f32
    ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(ours, pts)
    jax_write_ply(theirs, pts)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(read_ply(ours), pts.astype(np.float32))
    np.testing.assert_array_equal(read_ply(theirs), jax_read_ply(ours))


def test_read_ply_ascii_and_big_endian_equal_jax(tmp_path, rng):
    pts = rng.standard_normal((7, 3)).astype(np.float32)
    head = ("ply\nformat {} 1.0\nelement vertex 7\nproperty float x\n"
            "property float y\nproperty float z\nend_header\n")
    asc = tmp_path / "a.ply"
    asc.write_text(head.format("ascii") + "".join(
        f"{x} {y} {z}\n" for x, y, z in pts))
    big = tmp_path / "b.ply"
    big.write_bytes(head.format("binary_big_endian").encode()
                    + pts.astype(">f4").tobytes())
    for p in (asc, big):
        np.testing.assert_array_equal(read_ply(str(p)),
                                      jax_read_ply(str(p)))


@pytest.fixture(scope="module", autouse=True)
def jax_pointio_private(tmp_path_factory):
    """The JAX package's reader built from its own source into a private
    directory for this module: test workers that build the shared
    `bdm_tpu/native/_pointio.so` at the same time could load each other's
    half-written file."""
    lib = tmp_path_factory.mktemp("jax_pointio") / "_pointio.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointio, "_LIB_PATH", str(lib))
        mp.setattr(jax_pointio, "_lib", None)
        mp.setattr(jax_pointio, "_tried", False)
        yield


@pytest.fixture(params=["native", "fallback"])
def reader(request, monkeypatch):
    """The port's reader, built into `bdm_tpu_torch/_build/`, or, with the
    library disabled on both sides, its NumPy fallback against JAX's."""
    if request.param == "native":
        assert pointio.native_available(), "g++ build of pointio.cpp failed"
        assert jax_pointio.native_available()
    else:
        monkeypatch.setattr(pointio, "_load", lambda: None)
        monkeypatch.setattr(jax_pointio, "_load", lambda: None)
    return pointio


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_points", [0, 64])
def test_read_points_npy_equals_jax(tmp_path, rng, reader, dtype,
                                    max_points):
    pts = rng.standard_normal((500, 3)).astype(dtype)
    path = str(tmp_path / "c.npy")
    np.save(path, pts)
    got = reader.read_points(path, max_points=max_points, seed=7)
    np.testing.assert_array_equal(got, jax_pointio.read_points(
        path, max_points=max_points, seed=7))
    assert got.dtype == np.float32
    assert got.shape == ((max_points or 500), 3)
    if not max_points:
        np.testing.assert_array_equal(got, pts.astype(np.float32))


def test_read_points_ply_and_many_equal_jax(tmp_path, rng, reader):
    pts = rng.standard_normal((200, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    write_ply(path, pts)
    np.testing.assert_array_equal(reader.read_points(path), pts)
    np.testing.assert_array_equal(
        reader.read_points(path, max_points=50, seed=3),
        jax_pointio.read_points(path, max_points=50, seed=3))
    paths = []
    for i in range(5):
        p = str(tmp_path / f"c{i}.npy")
        np.save(p, rng.standard_normal((300, 3)).astype(np.float32))
        paths.append(p)
    got = reader.read_many_npy(paths, max_points=32, seed=1, n_threads=3)
    assert got.shape == (5, 32, 3)
    np.testing.assert_array_equal(got, jax_pointio.read_many_npy(
        paths, max_points=32, seed=1, n_threads=3))
