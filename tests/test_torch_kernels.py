"""gdrnet_tpu_torch.ops.kernels.nn_min_dist against cKDTree, the JAX Pallas
kernel (interpret mode) and the JAX adi_batch.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked by tests/test_torch_cuda.py, which skips without a card.
Tolerance: rtol 1e-4 against cKDTree (f64 search, f32 inputs), rtol 1e-5
against JAX's f32 paths (same f32 distances, other sum order).
"""

import numpy as np
import pytest
import torch
from scipy import spatial

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gdrnet_tpu_torch import csrc
from gdrnet_tpu_torch.ops.kernels import nn_min_dist, nn_min_dist_ref


def _golden(query, ref):
    return np.asarray([spatial.cKDTree(r).query(q, k=1)[0].mean()
                       for q, r in zip(query, ref)])


def _points(rng, b, n):
    return (rng.randn(b, n, 3) * 0.1).astype(np.float32)


# ragged sizes: one query, one reference point, sizes off any tile
SHAPES = [(3, 700, 500), (2, 1, 300), (2, 300, 1), (1, 1, 1), (2, 1001, 257)]


@pytest.mark.parametrize("b,nq,nr", SHAPES)
def test_nn_min_dist_ref_matches_kdtree(rng, b, nq, nr):
    q, r = _points(rng, b, nq), _points(rng, b, nr)
    got = nn_min_dist_ref(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, _golden(q, r), rtol=1e-4)


@pytest.mark.parametrize("b,nq,nr", [(2, 300, 400), (1, 129, 77)])
def test_nn_min_dist_ref_matches_pallas_interpret(rng, b, nq, nr):
    from gdrnet_tpu.ops.pallas_kernels import nn_min_dist_pallas

    q, r = _points(rng, b, nq), _points(rng, b, nr)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(nn_min_dist_pallas(jnp.asarray(q), jnp.asarray(r), tile_q=128))
    got = nn_min_dist_ref(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    # the Pallas kernel's |q|^2+|r|^2-2qr form loses up to ~1e-7 absolute to
    # cancellation at these spreads; the direct differences do not
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_nn_min_dist_ref_matches_jax_adi_batch(rng):
    from gdrnet_tpu.eval.pose_errors import adi_batch as jax_adi

    from gdrnet_tpu_torch.eval.pose_errors import adi_batch

    B, N = 3, 900
    Q, _ = np.linalg.qr(rng.randn(B, 3, 3))
    Re = (Q * np.sign(np.linalg.det(Q))[:, None, None]).astype(np.float32)
    Rg = np.roll(Re, 1, axis=0)
    te = (rng.rand(B, 3) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    tg = (te + rng.randn(B, 3) * 0.01).astype(np.float32)
    pts = ((rng.rand(N, 3) - 0.5) * 0.1).astype(np.float32)
    want = np.asarray(jax_adi(Re, te, Rg, tg, pts, chunk=256))
    got = adi_batch(*map(torch.from_numpy, (Re, te, Rg, tg, pts))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_wrapper_on_cpu_runs_plain_version_without_launch(rng):
    q, r = torch.from_numpy(_points(rng, 2, 50)), torch.from_numpy(_points(rng, 2, 60))
    before = nn_min_dist.launches
    np.testing.assert_array_equal(nn_min_dist(q, r).numpy(), nn_min_dist_ref(q, r).numpy())
    assert nn_min_dist.launches == before == 0


@pytest.mark.parametrize("case", ["f64", "last_dim", "batch", "strided", "empty"])
def test_wrapper_rejects_bad_inputs(case):
    q, r = torch.zeros(2, 5, 3), torch.zeros(2, 4, 3)
    if case == "f64":
        q = q.double()
    elif case == "last_dim":
        q = torch.zeros(2, 5, 4)
    elif case == "batch":
        r = torch.zeros(3, 4, 3)
    elif case == "strided":
        q = torch.zeros(2, 3, 5).transpose(1, 2)
    elif case == "empty":
        r = torch.zeros(2, 0, 3)
    with pytest.raises((TypeError, ValueError)):
        nn_min_dist(q, r)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        csrc.build("nn_min_dist")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
