"""The CUDA kernels of gdrnet_tpu_torch against their plain PyTorch versions:
nn_min_dist (B1) and rasterize_xyz (B2).

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py does import JAX, so on such a machine run it as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.kernels import (
    nn_min_dist,
    nn_min_dist_ref,
    rasterize_xyz,
    rasterize_xyz_ref,
)

# ragged sizes: one query, one reference point, sizes off any tile
SHAPES = [(3, 700, 500), (2, 1, 300), (2, 300, 1), (1, 1, 1), (2, 1001, 257),
          (64, 3000, 3000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nr", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, nq, nr):
    g = torch.Generator().manual_seed(b * 7919 + nq * 31 + nr)
    q = (torch.randn(b, nq, 3, generator=g) * 0.1).to(cuda_device)
    r = (torch.randn(b, nr, 3, generator=g) * 0.1).to(cuda_device)
    before = kernels.nn_min_dist.launches
    got = nn_min_dist(q, r)
    torch.cuda.synchronize()
    assert kernels.nn_min_dist.launches == before + 1
    # same f32 distances, another summation order
    torch.testing.assert_close(got, nn_min_dist_ref(q, r), rtol=1e-5, atol=1e-7)
    # runs give identical results: fixed-order reduction, no atomics
    assert torch.equal(got, nn_min_dist(q, r))


def _tower(rounds: int = 0):
    """The tower of tools/gen_scale_dataset.py:mesh_zoo (448 faces), after
    `rounds` rounds of its _subdivide (x4 faces each)."""
    spec = importlib.util.spec_from_file_location(
        "gen_scale_dataset", Path(__file__).resolve().parents[1] / "tools/gen_scale_dataset.py")
    gsd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gsd)
    _, v, f, _ = gsd.mesh_zoo()[3]
    for _ in range(rounds):
        v, f = gsd._subdivide(v, f)
    return v, f


def _raster_inputs(case: str, device):
    """(args of rasterize_xyz, height, width) of one test case."""
    g = np.random.RandomState(sum(map(ord, case)))
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)
    v, f = _tower()
    B, h, w = 16, 128, 128
    centres = np.stack([g.uniform(200, 440, B), g.uniform(140, 340, B), np.ones(B)], 1)
    if case == "one_face":
        v = np.array([[-0.05, -0.04, 0.0], [0.06, -0.03, 0.01], [0.0, 0.05, -0.01]], np.float32)
        f = np.array([[0, 1, 2]], np.int32)
    elif case == "ragged_faces":  # F on no chunk boundary, window off any tile
        v, f = _tower(1)
        f, h, w = f[:777], 90, 100
    elif case == "off_frame":  # objects at the frame's corners, windows over its edges
        centres[:2] = [[5.0, 475.0, 1.0], [636.0, 3.0, 1.0]]
    elif case == "subdivided":
        v, f = _tower(2)
        h = w = 256
    q = np.linalg.qr(g.randn(B, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t = (g.uniform(0.5, 1.2, (B, 1)) * centres @ np.linalg.inv(K).T).astype(np.float32)
    if case == "behind_camera":
        t[:, 2] *= -1
    c = centres[:, :2] - [w // 2, h // 2]
    origins = np.floor(c).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (v, f, np.broadcast_to(K, (B, 3, 3)), R, t, origins)]
    return args, h, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["batch16", "one_face", "ragged_faces", "off_frame",
                                  "behind_camera", "subdivided"])
def test_rasterize_xyz_kernel_matches_plain_version(cuda_device, case):
    args, h, w = _raster_inputs(case, cuda_device)
    before = kernels.rasterize_xyz.launches
    depth, xyz = rasterize_xyz(*args, h, w)
    torch.cuda.synchronize()
    assert kernels.rasterize_xyz.launches == before + 1
    want_depth, want_xyz = rasterize_xyz_ref(*args, h, w)
    # one face table, every operation rounded alike: equal hit masks and,
    # in f32, depth / xyz within 1e-6 m (bitwise equal is expected)
    assert torch.equal(depth > 0, want_depth > 0)
    torch.testing.assert_close(depth, want_depth, rtol=0, atol=1e-6)
    torch.testing.assert_close(xyz, want_xyz, rtol=0, atol=1e-6)
    assert ((depth > 0).sum() == 0) == (case == "behind_camera")
    again = rasterize_xyz(*args, h, w)
    assert torch.equal(depth, again[0]) and torch.equal(xyz, again[1])
