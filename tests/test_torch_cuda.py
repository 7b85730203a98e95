"""The CUDA kernels of gdrnet_tpu_torch against their plain PyTorch versions.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py does import JAX, so on such a machine run it as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.kernels import nn_min_dist, nn_min_dist_ref

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
