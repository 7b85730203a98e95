"""Farthest point sampling in the port (gdrnet_tpu_torch/ops/fps.py: the
device FPS, run here on the CPU, and the C++ twin csrc/fps.cpp) and its CLI
(gdrnet_tpu_torch/tools/compute_fps.py) against the JAX package's numpy FPS,
its device FPS and its tool (tools/compute_fps.py, loaded from its path).

Every comparison is bit for bit. The port's samplers equal numpy's on every
cloud, the tie-heavy lattice and cylinder included; JAX's device FPS equals
them on the random cloud, where no two distances tie (on the lattice and
the cylinder XLA's rounding breaks ties otherwise: tests/fps_tie_counts.py
counts the picks that differ).
"""

import importlib.util
import os
import os.path as osp
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.ops import fps as jfps

from gdrnet_tpu_torch import csrc
from gdrnet_tpu_torch.data.synthetic import cylinder_cloud, lattice_cloud
from gdrnet_tpu_torch.ops import fps
from gdrnet_tpu_torch.tools import compute_fps
from gdrnet_tpu_torch.tools import gen_scale_dataset as gen
from fixture_bop import build_fixture_dataset
from torch_parity import REPO

CLOUDS = {"random": lambda: np.random.RandomState(0).rand(2000, 3).astype(np.float32),
          "lattice_9": lambda: lattice_cloud(9),
          "cylinder_96x40": lambda: cylinder_cloud(96, 40)}
# (init_center, start_idx): start_idx is the first pick without init_center
STARTS = [(True, 0), (False, 0), (False, 7)]
KS = [1, 8, 64, "n"]
CENTER_ATOL = 1e-6


@pytest.fixture(scope="module")
def clouds():
    return {name: make() for name, make in CLOUDS.items()}


def _k(k, pts):
    return len(pts) if k == "n" else k


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("init_center,start_idx", STARTS)
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_device_fps_on_the_cpu_equals_numpy(clouds, cloud, init_center, start_idx, k):
    pts = clouds[cloud]
    k = _k(k, pts)
    want = fps.farthest_point_sampling_np_idx(pts, k, init_center, start_idx)
    got = fps.farthest_point_sampling_idx(pts, k, init_center, start_idx, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int64 and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("init_center", [True, False])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_device_fps_points_equal_numpy(clouds, cloud, init_center):
    pts = clouds[cloud]
    got = fps.farthest_point_sampling(torch.from_numpy(pts), 64, init_center)
    assert got.dtype == torch.float32 and got.shape == (64, 3)
    np.testing.assert_array_equal(got.numpy(), fps.farthest_point_sampling_np(pts, 64, init_center))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("init_center,start_idx", STARTS)
def test_device_fps_equals_jax_on_the_random_cloud(clouds, init_center, start_idx, k):
    pts = clouds["random"]
    k = _k(k, pts)
    want = np.asarray(jfps.farthest_point_sampling_idx(jnp.asarray(pts), k,
                                                       init_center=init_center,
                                                       start_idx=start_idx))
    got = fps.farthest_point_sampling_idx(pts, k, init_center, start_idx, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_copy_equals_jax_numpy_on_ties(clouds):
    for pts in clouds.values():
        for init_center, start_idx in STARTS:
            np.testing.assert_array_equal(
                fps.farthest_point_sampling_np(pts, 64, init_center, start_idx),
                jfps.farthest_point_sampling_np(pts, 64, init_center, start_idx))


@pytest.mark.parametrize("init_center", [True, False])
def test_get_fps_and_center_matches_jax(clouds, init_center):
    pts = clouds["random"]
    want = np.asarray(jfps.get_fps_and_center(pts, 8, init_center=init_center))
    got = fps.get_fps_and_center(pts, 8, init_center=init_center, device="cpu").numpy()
    assert got.shape == (9, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:8], want[:8])
    np.testing.assert_allclose(got[8], want[8], rtol=0, atol=CENTER_ATOL)


def test_device_fps_keeps_a_tensor_on_its_device_and_checks_start_idx(clouds):
    pts = torch.from_numpy(clouds["lattice_9"]).double()
    idx = fps.farthest_point_sampling_idx(pts, 5)
    assert idx.device.type == "cpu"
    np.testing.assert_array_equal(idx.numpy(),
                                  fps.farthest_point_sampling_np_idx(clouds["lattice_9"], 5))
    assert fps.farthest_point_sampling_idx(pts, 0).shape == (0,)
    with pytest.raises(ValueError, match="start_idx"):
        fps.farthest_point_sampling_idx(pts, 4, init_center=False, start_idx=len(pts))


@pytest.mark.parametrize("init_center,start_idx", STARTS)
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_cpp_twin_equals_numpy(clouds, cloud, init_center, start_idx):
    pts = clouds[cloud]
    for k in KS:
        k = _k(k, pts)
        want = fps.farthest_point_sampling_np_idx(pts, k, init_center, start_idx)
        np.testing.assert_array_equal(
            fps.farthest_point_sampling_cpp_idx(pts, k, init_center, start_idx), want)
        np.testing.assert_array_equal(
            fps.farthest_point_sampling_cpp(pts, k, init_center, start_idx), pts[want])


@pytest.mark.parametrize("k,init_center,start_idx", [(2001, True, 0), (0, True, 0),
                                                     (4, False, -1), (4, False, 2000)])
def test_cpp_twin_raises_on_its_error_code(clouds, k, init_center, start_idx):
    with pytest.raises(ValueError, match="fps_sample failed"):
        fps.farthest_point_sampling_cpp(clouds["random"], k, init_center, start_idx)


def _jax_tool():
    """tools/compute_fps.py loaded from its path, on the numpy sampler (where
    g++ is present it samples with gdrnet_tpu/csrc/fps, whose -march=native
    build breaks ties otherwise)."""
    spec = importlib.util.spec_from_file_location("jax_compute_fps",
                                                  REPO / "tools/compute_fps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._sampler = lambda: jfps.farthest_point_sampling_np
    return mod


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same_pkl(got: dict, want: dict):
    assert list(got) == list(want)
    for obj in want:
        assert list(got[obj]) == list(want[obj]), obj
        for key, arr in want[obj].items():
            assert got[obj][key].dtype == arr.dtype == np.float32, (obj, key)
            np.testing.assert_array_equal(got[obj][key], arr, err_msg=f"{obj} {key}")


@pytest.fixture(scope="module")
def fixture_models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fps_fixture"))
    build_fixture_dataset(root, n_images=1)
    return osp.join(root, "models")


@pytest.fixture(scope="module")
def zoo_models(tmp_path_factory):
    """The generator's 10-mesh models directory (its fps_points.pkl written
    with the numpy sampler)."""
    root = str(tmp_path_factory.mktemp("fps_zoo"))
    gen.write_models(root, gen.mesh_zoo())
    return osp.join(root, "models")


@pytest.mark.parametrize("models", ["fixture_models", "zoo_models"])
def test_cli_on_the_cpu_equals_the_jax_tool(request, capsys, models):
    """The file bit for bit, and the printed lines word for word."""
    mdir = request.getfixturevalue(models)
    out = osp.join(mdir, "fps_points.pkl")
    capsys.readouterr()
    _jax_tool().main(["--models-dir", mdir])
    want, printed = _read(out), capsys.readouterr().out
    os.remove(out)
    assert compute_fps.main(["--models-dir", mdir, "--device", "cpu"]) == out
    _assert_same_pkl(_read(out), want)
    assert capsys.readouterr().out == printed and printed.endswith(f"saved {out}\n")
    assert any(len(e) > 1 for e in want.values())


def test_device_sampler_on_the_cpu_equals_the_generators_file(zoo_models):
    ids = list(range(1, len(gen.mesh_zoo()) + 1))
    got = compute_fps.compute_fps_dict(zoo_models, ids,
                                       sampler=compute_fps.device_sampler("cpu"))
    _assert_same_pkl(got, _read(osp.join(zoo_models, "fps_points.pkl")))


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_cli_without_a_card_raises(fixture_models, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        compute_fps.main(["--models-dir", fixture_models, *argv])


def test_cli_on_the_cpu_without_gxx_raises(tmp_path, monkeypatch):
    build_fixture_dataset(str(tmp_path), n_images=1)
    mdir = str(tmp_path / "models")

    def no_gxx():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(csrc, "find_gxx", no_gxx)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    fps._loaded.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            compute_fps.main(["--models-dir", mdir, "--device", "cpu"])
    finally:
        fps._loaded.cache_clear()
    assert not osp.exists(osp.join(mdir, "fps_points.pkl"))
