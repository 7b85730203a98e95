"""The port's VSD (gdrnet_tpu_torch/eval/vsd.py) and its MSSD / MSPD
(eval/pose_errors.py) against the JAX package, on the CPU.

Tolerances:
- vsd_from_depths on the same depth images: atol 1e-6 (the same f32
  distance images and integer pixel counts; the distance images may differ
  in the last bit, which can move a pixel across a threshold only by
  chance);
- vsd / vsd_pairs on the tests/fixture_bop.py dataset, each side rendering
  its own depths: atol 1e-4, as tests/test_bop_score.py holds JAX (depths
  agree to ~1e-6 m, so at most a pixel or two of a union of thousands may
  change side of a threshold);
- mssd_batch / mspd_batch: rtol 1e-5 (f32 products summed in another order).
"""

import numpy as np
import pytest
import torch

from gdrnet_tpu.data.bop import load_bop_scene_dicts
from gdrnet_tpu.data.io import load_depth
from gdrnet_tpu.data.ply import load_ply
from gdrnet_tpu.eval import pose_errors as jPE
from gdrnet_tpu.eval import vsd as jvsd
from gdrnet_tpu.ops.rasterizer import render_depth

from gdrnet_tpu_torch.eval import pose_errors as PE
from gdrnet_tpu_torch.eval import vsd
from fixture_bop import build_fixture_dataset

TAUS = np.arange(0.05, 0.51, 0.05)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    meta = build_fixture_dataset(str(tmp_path_factory.mktemp("vsd")), n_images=2, seed=5)
    records = load_bop_scene_dicts(meta, "test")
    meshes = {oid: load_ply(meta.model_path(oid), vertex_scale=0.001) for oid in (1, 2)}
    return meta, records, meshes


def _perturbed(rng, R, t, deg, sigma):
    ax = rng.randn(3)
    ax /= np.linalg.norm(ax)
    a = np.radians(deg)
    Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    dR = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx
    return (dR @ R).astype(np.float32), (t + rng.randn(3) * sigma).astype(np.float32)


def _pairs(fixture, rng, deg=6.0, sigma=0.006):
    """Per record: (est R, est t, record); est scattered around the GT."""
    _, records, _ = fixture
    return [(*_perturbed(rng, r["R"], r["t"], deg, sigma), r) for r in records]


@pytest.mark.parametrize("cost_type,visib_mode,normalized", [
    ("step", "bop19", True), ("tlinear", "bop19", True), ("step", "bop18", False)])
def test_vsd_from_depths_matches_jax(fixture, rng, cost_type, visib_mode, normalized):
    meta, _, meshes = fixture
    pairs = _pairs(fixture, rng)
    d_est, d_gt, d_test, Ks = [], [], [], []
    for R_e, t_e, r in pairs:
        m = meshes[r["obj_id"]]
        d_est.append(np.asarray(render_depth(m["pts"], m["faces"], r["K"], R_e, t_e,
                                             meta.height, meta.width)))
        d_gt.append(np.asarray(render_depth(m["pts"], m["faces"], r["K"], r["R"], r["t"],
                                            meta.height, meta.width)))
        d_test.append(load_depth(r["depth_path"], r["depth_scale"]))
        Ks.append(r["K"])
    want = np.stack([np.asarray(jvsd.vsd_from_depths(
        e, g, te, k, 0.015, TAUS.astype(np.float32), 0.1,
        normalized_by_diameter=normalized, cost_type=cost_type, visib_mode=visib_mode))
        for e, g, te, k in zip(d_est, d_gt, d_test, Ks)])
    got = vsd.vsd_from_depths(*(torch.from_numpy(np.stack(a)) for a in (d_est, d_gt, d_test, Ks)),
                              0.015, TAUS, 0.1, normalized_by_diameter=normalized,
                              cost_type=cost_type, visib_mode=visib_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0.0 < want.min() and want.max() < 1.0


def test_vsd_of_empty_union_is_one():
    z = torch.zeros(1, 6, 8)
    K = torch.tensor([[[50.0, 0, 4], [0, 50.0, 3], [0, 0, 1]]])
    np.testing.assert_array_equal(vsd.vsd_from_depths(z, z, z, K, 0.015, TAUS, 0.1).numpy(),
                                  np.ones((1, len(TAUS)), np.float32))


def test_visibility_masks_equal_jax(rng):
    d_test, d_model, d_est = (np.where(rng.rand(12, 9) < 0.3, 0.0,
                                       rng.uniform(0.4, 0.6, (12, 9))).astype(np.float32)
                              for _ in range(3))
    for mode in ("bop19", "bop18"):
        gt_p = vsd.estimate_visib_mask_gt(torch.from_numpy(d_test), torch.from_numpy(d_model),
                                          0.015, mode)
        gt_j = np.asarray(jvsd.estimate_visib_mask_gt(d_test, d_model, 0.015, mode))
        np.testing.assert_array_equal(gt_p.numpy(), gt_j)
        est_p = vsd.estimate_visib_mask_est(torch.from_numpy(d_test), torch.from_numpy(d_est),
                                            gt_p, 0.015, mode)
        est_j = jvsd.estimate_visib_mask_est(d_test, d_est, gt_j, 0.015, mode)
        np.testing.assert_array_equal(est_p.numpy(), np.asarray(est_j))


def test_vsd_matches_jax(fixture, rng):
    _, _, meshes = fixture
    for R_e, t_e, r in _pairs(fixture, rng)[:2]:
        m = meshes[r["obj_id"]]
        d_test = load_depth(r["depth_path"], r["depth_scale"])
        args = (R_e, t_e, r["R"], r["t"], d_test, r["K"], m["pts"], m["faces"])
        want = jvsd.vsd(*args, diameter=0.12)
        got = vsd.vsd(*args, diameter=0.12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert got.shape == (len(TAUS),)


def test_vsd_pairs_matches_jax(fixture, rng):
    _, _, meshes = fixture
    pairs = [p for p in _pairs(fixture, rng, deg=10.0, sigma=0.01) if p[2]["obj_id"] == 2]
    m = meshes[2]
    args = (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            np.stack([p[2]["R"] for p in pairs]), np.stack([p[2]["t"] for p in pairs]),
            np.stack([load_depth(p[2]["depth_path"]) for p in pairs]),
            np.stack([p[2]["K"] for p in pairs]), m["pts"], m["faces"])
    want = jvsd.vsd_pairs(*args, diameter=0.13)
    got = vsd.vsd_pairs(*args, diameter=0.13)
    assert got.shape == want.shape == (len(pairs), len(TAUS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _sym_case(rng, B, N, K):
    q = np.linalg.qr(rng.randn(2 * B, 3, 3))[0]
    q = q * np.sign(np.linalg.det(q))[:, None, None]
    R_est, R_gt = q[:B].astype(np.float32), q[B:].astype(np.float32)
    t_gt = np.concatenate([rng.randn(B, 2) * 0.05, rng.uniform(0.4, 0.9, (B, 1))], 1)
    t_est = t_gt + rng.randn(B, 3) * 0.01
    pts = ((rng.rand(N, 3) - 0.5) * 0.1).astype(np.float32)
    Kc = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                 (B, 1, 1))
    sym = np.tile(np.eye(3, dtype=np.float32), (B, K, 1, 1))
    for k in range(1, K):
        c, s = np.cos(2 * np.pi * k / K), np.sin(2 * np.pi * k / K)
        sym[:, k] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    mask = np.ones((B, K), bool)
    if K > 2:
        mask[::2, -1] = False
    return (R_est, t_est.astype(np.float32), R_gt, t_gt.astype(np.float32), Kc, pts, sym,
            mask)


@pytest.mark.parametrize("K", [1, 4])
def test_mssd_mspd_match_jax(rng, K):
    R_est, t_est, R_gt, t_gt, Kc, pts, sym, mask = _sym_case(rng, 6, 200, K)
    T = torch.from_numpy
    want = np.asarray(jPE.mssd_batch(R_est, t_est, R_gt, t_gt, pts, sym, mask))
    got = PE.mssd_batch(T(R_est), T(t_est), T(R_gt), T(t_gt), T(pts), T(sym), T(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    want = np.asarray(jPE.mspd_batch(R_est, t_est, R_gt, t_gt, Kc, pts, sym, mask))
    got = PE.mspd_batch(T(R_est), T(t_est), T(R_gt), T(t_gt), T(Kc), T(pts), T(sym), T(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # per-sample point sets [B, N, 3]
    pts_b = np.stack([pts * (1 + 0.1 * i) for i in range(6)]).astype(np.float32)
    want = np.asarray(jPE.mssd_batch(R_est, t_est, R_gt, t_gt, pts_b, sym, mask))
    got = PE.mssd_batch(T(R_est), T(t_est), T(R_gt), T(t_gt), T(pts_b), T(sym), T(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
