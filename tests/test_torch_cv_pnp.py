"""The port's numpy stand-ins of cv2's PnP (eval/cv_pnp.py) against cv2 5.0,
and the host PnP path (eval/pnp.py, engine/pnp_refine.py's host loop)
against the JAX package's, which calls cv2.

Bounds:
- Rodrigues within 1e-12 in both directions. A matrix goes through an SVD
  first (cv2's Jacobi SVD, numpy's LAPACK), whose last bits differ, and
  two angles amplify them: near 0 the angle is acos(c) (1e-11 at 1e-4
  rad), at a half turn the axis is sqrt(1 + R_ii) (1e-7).
- solvePnP ITERATIVE (Levenberg-Marquardt from a guess, or from cv2's own
  start: a DLT, or a homography for planar points) within 1e-3 degrees and
  1e-6 m of cv2's pose.
- solvePnP P3P within 1e-6 rad and 1e-6 m of cv2 on 100 well-conditioned
  sets, exact and noisy; on sets whose roots nearly tie on the fourth point
  the chosen root may flip, and the flips are counted (at most 3 of 100).
  A RANSAC call of exactly 4 points is that P3P on f32 points, within the
  same bound.
- EPnP exact on clean data (1e-6 degrees, 1e-9 m). On noisy data cv2 5.0's
  EPnP returns other poses than calib3d's epnp.cpp, which the stand-in
  follows, so there both are held to the truth: the stand-in's rotation
  error at most 1.5x cv2's + 0.05 degrees (tests/test_device_pnp.py:56-74).
- solvePnPRansac draws cv2's own minimal sets: on 30 % gross outliers the
  inlier set equals cv2's, and the pose obeys the EPnP rule; with ITERATIVE
  flags (the refit is LM) the pose is within the ITERATIVE bound.
- The host refine_bucket_poses against JAX's on one bucket in each mode:
  net_iter_pnp within the ITERATIVE bound, the RANSAC modes by the EPnP rule.
"""

import cv2
import numpy as np
import pytest

from gdrnet_tpu.eval import pnp as jpnp

from gdrnet_tpu_torch.eval import cv_pnp, pnp
from test_torch_pnp import axis_angle, bucket, refine_both, rot_deg

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]])
DIST = np.zeros((8, 1))
ITER_DEG, ITER_M = 1e-3, 1e-6
P3P_DEG, P3P_M = np.degrees(1e-6), 1e-6


def scene(rng, n: int = 300, noise: float = 0.0, outlier_frac: float = 0.0):
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    R = Q * np.sign(np.linalg.det(Q))
    t = np.array([0.05, -0.03, 0.9]) + rng.randn(3) * 0.05
    p3 = (rng.rand(n, 3) - 0.5) * 0.2
    uv = (p3 @ R.T + t) @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.randn(n, 2) * noise
    k = int(n * outlier_frac)
    if k:
        uv[n - k:] = rng.rand(k, 2) * [640, 480]
    return R, t, p3, uv


def cv_R(rvec) -> np.ndarray:
    return cv2.Rodrigues(rvec)[0]


def epnp_rule(got_R, cv_Rm, R_true) -> bool:
    return rot_deg(got_R, R_true) <= 1.5 * rot_deg(cv_Rm, R_true) + 0.05


@pytest.mark.parametrize("case", ["random", "small", "tiny", "zero", "half_turn"])
def test_rodrigues_equals_cv2(case):
    rng = np.random.RandomState(0)
    axes = rng.randn(6, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angle = {"random": rng.uniform(0.1, 3.0, 6), "small": np.full(6, 1e-4),
             "tiny": np.full(6, 1e-9), "zero": np.zeros(6), "half_turn": np.full(6, np.pi)}[case]
    for r in axes * angle[:, None]:
        np.testing.assert_allclose(cv_pnp.rodrigues(r), cv_R(r), rtol=0, atol=1e-12)
        Rm = cv_R(r)
        atol = {"half_turn": 1e-7, "small": 1e-11}.get(case, 1e-12)
        np.testing.assert_allclose(cv_pnp.rodrigues(Rm), cv2.Rodrigues(Rm)[0], rtol=0, atol=atol)
        assert cv_pnp.rodrigues(Rm).shape == (3, 1)
    with pytest.raises(cv_pnp.PnPError):
        cv_pnp.rodrigues(np.eye(4))


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_epnp_against_cv2(noise):
    rng = np.random.RandomState(1)
    for _ in range(6):
        R, t, p3, uv = scene(rng, noise=noise)
        ok, rvec, tvec = cv2.solvePnP(p3, uv, K, DIST, flags=cv2.SOLVEPNP_EPNP)
        ok2, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="epnp")
        assert ok and ok2 and rv.shape == tv.shape == (3, 1)
        if noise == 0.0:
            assert rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < 1e-6
            np.testing.assert_allclose(tv, tvec, rtol=0, atol=1e-9)
        else:
            assert epnp_rule(cv_pnp.rodrigues(rv), cv_R(rvec), R)
            assert np.linalg.norm(tv.ravel() - t) < 0.01


@pytest.mark.parametrize("guess", [True, False])
def test_iterative_equals_cv2(guess):
    rng = np.random.RandomState(2)
    for _ in range(5):
        R, t, p3, uv = scene(rng, noise=0.5)
        rv0 = cv2.Rodrigues(axis_angle(rng, 8.0) @ R)[0]
        tv0 = (t + [0.03, -0.02, 0.05]).reshape(3, 1)
        kw = dict(rvec=rv0.copy(), tvec=tv0.copy(), useExtrinsicGuess=True) if guess else {}
        ok, rvec, tvec = cv2.solvePnP(p3, uv, K, DIST, flags=cv2.SOLVEPNP_ITERATIVE, **kw)
        ok2, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="iterative", rvec=rv0, tvec=tv0,
                                       use_extrinsic_guess=guess)
        assert ok and ok2
        assert rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < ITER_DEG
        np.testing.assert_allclose(tv, tvec, rtol=0, atol=ITER_M)


@pytest.mark.parametrize("guess", [False, True])
def test_ransac_epnp_draws_cv2_minimal_sets(guess):
    """30 % gross outliers: cv2's inlier set, and the EPnP rule on the pose
    (with EPnP flags cv2 ignores the guess)."""
    rng = np.random.RandomState(3)
    for _ in range(6):
        R, t, p3, uv = scene(rng, noise=0.5, outlier_frac=0.3)
        rv0, tv0 = cv2.Rodrigues(axis_angle(rng, 10.0) @ R)[0], (t + 0.05).reshape(3, 1)
        kw = dict(rvec=rv0.copy(), tvec=tv0.copy(), useExtrinsicGuess=True) if guess else {}
        ok, rvec, tvec, inl = cv2.solvePnPRansac(p3, uv, K, DIST, flags=cv2.SOLVEPNP_EPNP,
                                                 reprojectionError=3.0, iterationsCount=100,
                                                 **kw)
        ok2, rv, tv, inl2 = cv_pnp.solve_pnp_ransac(
            p3, uv, K, flags="epnp", use_extrinsic_guess=guess, rvec=rv0, tvec=tv0,
            iterations_count=100, reprojection_error=3.0)
        assert ok and ok2
        np.testing.assert_array_equal(inl2, inl)
        assert epnp_rule(cv_pnp.rodrigues(rv), cv_R(rvec), R)
        assert np.linalg.norm(tv.ravel() - t) < 0.01


def test_ransac_iterative_flags_and_small_sets_equal_cv2():
    rng = np.random.RandomState(4)
    for _ in range(3):  # ITERATIVE flags: LM from the best minimal set on its inliers
        R, t, p3, uv = scene(rng, n=200, noise=0.5, outlier_frac=0.3)
        ok, rvec, tvec, inl = cv2.solvePnPRansac(p3, uv, K, DIST, flags=cv2.SOLVEPNP_ITERATIVE,
                                                 reprojectionError=3.0)
        ok2, rv, tv, inl2 = cv_pnp.solve_pnp_ransac(p3, uv, K, reprojection_error=3.0)
        np.testing.assert_array_equal(inl2, inl)
        assert rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < ITER_DEG
        np.testing.assert_allclose(tv, tvec, rtol=0, atol=ITER_M)
    for n in (5, 4):  # one solve on all points (for 4, P3P whatever the flags)
        R, t, p3, uv = scene(rng, n=n)
        ok, rvec, tvec, inl = cv2.solvePnPRansac(p3, uv, K, DIST, flags=cv2.SOLVEPNP_EPNP)
        ok2, rv, tv, inl2 = cv_pnp.solve_pnp_ransac(p3, uv, K, flags="epnp")
        assert ok and ok2 and len(inl2) == len(inl) == n
        assert rot_deg(cv_pnp.rodrigues(rv), R) < 1e-3 and rot_deg(cv_R(rvec), R) < 1e-3
    with pytest.raises(cv_pnp.PnPError):
        cv_pnp.solve_pnp_ransac(p3[:3], uv[:3], K)
    with pytest.raises(cv_pnp.PnPError):
        cv_pnp.solve_pnp(p3[:3], uv[:3], K)
    ok, rvec, tvec = cv2.solvePnP(p3, uv, K, DIST, flags=cv2.SOLVEPNP_P3P)
    ok2, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="p3p")
    assert ok and ok2 and rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < P3P_DEG
    np.testing.assert_allclose(tv, tvec, rtol=0, atol=P3P_M)
    for flags in ("ap3p", "sqpnp", "ippe"):  # cv2's own solvers, reached by no JAX path
        with pytest.raises(NotImplementedError, match="no path of the JAX package"):
            cv_pnp.solve_pnp(p3, uv, K, flags=flags)


def _p3p_gap(p3, uv) -> tuple[float, float]:
    """cv2's P3P and the stand-in's on one set of 4: (degrees, metres)."""
    ok, rvec, tvec = cv2.solvePnP(p3, uv, K, DIST, flags=cv2.SOLVEPNP_P3P)
    ok2, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="p3p")
    assert ok == ok2
    if not ok:
        return 0.0, 0.0
    return rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)), float(np.abs(tv - tvec).max())


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_p3p_equals_cv2(noise):
    """100 well-conditioned sets of 4; exact ones also hold the truth."""
    rng = np.random.RandomState(7)
    for _ in range(100):
        R, t, p3, uv = scene(rng, n=4, noise=noise)
        deg, m = _p3p_gap(p3, uv)
        assert deg < P3P_DEG and m < P3P_M, (deg, m)
        if noise == 0.0:
            _, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="p3p")
            assert rot_deg(cv_pnp.rodrigues(rv), R) < P3P_DEG
            np.testing.assert_allclose(tv.ravel(), t, rtol=0, atol=P3P_M)


def test_p3p_root_flips_on_degenerate_sets_are_counted():
    """Sets of 4 nearly on a line through the first three (roots that nearly
    tie on the fourth point), with 2 px of noise: the chosen roots that part
    from cv2's are counted, not hidden."""
    rng = np.random.RandomState(8)
    flips = 0
    for _ in range(100):
        R, t, p3, uv = scene(rng, n=4, noise=2.0)
        p3[3] = p3[0] + 0.5 * (p3[1] - p3[0]) + rng.randn(3) * 1e-3
        pc = (R @ p3[3] + t) @ K.T
        uv[3] = pc[:2] / pc[2] + rng.randn(2) * 2.0
        deg, m = _p3p_gap(p3, uv)
        flips += deg >= P3P_DEG or m >= P3P_M
    print(f"P3P root flips against cv2 on 100 degenerate sets: {flips}")
    assert flips <= 3


def test_ransac_of_four_points_is_p3p_as_in_cv2():
    rng = np.random.RandomState(9)
    for _ in range(10):
        R, t, p3, uv = scene(rng, n=4, noise=1.0)
        for flags, name in ((cv2.SOLVEPNP_EPNP, "epnp"), (cv2.SOLVEPNP_ITERATIVE, "iterative"),
                            (cv2.SOLVEPNP_P3P, "p3p")):
            ok, rvec, tvec, inl = cv2.solvePnPRansac(p3, uv, K, DIST, flags=flags)
            ok2, rv, tv, inl2 = cv_pnp.solve_pnp_ransac(p3, uv, K, flags=name)
            assert ok and ok2
            np.testing.assert_array_equal(inl2, inl)
            assert rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < ITER_DEG
            np.testing.assert_allclose(tv, tvec, rtol=0, atol=ITER_M)


def test_ransac_p3p_draws_cv2_minimal_sets():
    """Minimal sets of 4 by P3P on 30 % gross outliers: cv2's inlier set, and
    the EPnP refit's rule on the pose."""
    rng = np.random.RandomState(10)
    for _ in range(4):
        R, t, p3, uv = scene(rng, noise=0.5, outlier_frac=0.3)
        ok, rvec, tvec, inl = cv2.solvePnPRansac(p3, uv, K, DIST, flags=cv2.SOLVEPNP_P3P,
                                                 reprojectionError=3.0, iterationsCount=100)
        ok2, rv, tv, inl2 = cv_pnp.solve_pnp_ransac(p3, uv, K, flags="p3p",
                                                    reprojection_error=3.0, iterations_count=100)
        assert ok and ok2
        np.testing.assert_array_equal(inl2, inl)
        assert epnp_rule(cv_pnp.rodrigues(rv), cv_R(rvec), R)
        assert np.linalg.norm(tv.ravel() - t) < 0.01


def test_iterative_without_guess_starts_as_cv2():
    """Planar points start from the homography, others from the DLT, which
    needs 6 (cv2 raises below)."""
    rng = np.random.RandomState(11)
    for planar in (False, True):
        for _ in range(4):
            R, t, p3, uv = scene(rng, n=50)
            if planar:
                p3[:, 2] = 0.0
            uv = (p3 @ R.T + t) @ K.T
            uv = uv[:, :2] / uv[:, 2:3] + rng.randn(50, 2) * 0.5
            ok, rvec, tvec = cv2.solvePnP(p3, uv, K, DIST, flags=cv2.SOLVEPNP_ITERATIVE)
            ok2, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="iterative")
            assert ok and ok2
            assert rot_deg(cv_pnp.rodrigues(rv), cv_R(rvec)) < ITER_DEG
            np.testing.assert_allclose(tv, tvec, rtol=0, atol=ITER_M)
    with pytest.raises(cv2.error):
        cv2.solvePnP(p3[:5] + [[0, 0, 0.01]] * np.arange(5)[:, None], uv[:5], K, DIST,
                     flags=cv2.SOLVEPNP_ITERATIVE)
    with pytest.raises(cv_pnp.PnPError, match="6 non-planar"):
        cv_pnp.solve_pnp(p3[:5] + [[0, 0, 0.01]] * np.arange(5)[:, None], uv[:5], K,
                         flags="iterative")


# ---------------------------------------------------------------------------
# eval/pnp.py against the JAX package's (cv2)
# ---------------------------------------------------------------------------


def test_correspondences_equal_jax():
    rng = np.random.RandomState(5)
    mask = rng.rand(16, 16).astype(np.float32)
    xyzn = rng.rand(16, 16, 3).astype(np.float32)
    xyzn[3, 4] = 0.5  # on the axis planes: left out
    c2d = rng.rand(16, 16, 2).astype(np.float32)
    ext = np.array([0.1, 0.2, 0.15], np.float32)
    for max_n in (-1, 40):
        got = pnp.correspondences_from_maps(mask, xyzn, c2d, 640, 480, ext, 0.4, max_n)
        want = jpnp.correspondences_from_maps(mask, xyzn, c2d, 640, 480, ext, 0.4, max_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 40


def test_pnp_ransac_and_refine_from_net_equal_jax():
    rng = np.random.RandomState(6)
    R, t, p3, uv = scene(rng, noise=0.5, outlier_frac=0.2)
    for method in ("epnp", "dls"):
        got, want = (f(p3, uv, K, method=method, ransac=True)
                     for f in (pnp.pnp_ransac, jpnp.pnp_ransac))
        assert epnp_rule(got[:, :3], want[:, :3], R) and got.shape == (3, 4)
    got = pnp.pnp_ransac(p3[:240], uv[:240], K, method="iterative", ransac=False)
    want = jpnp.pnp_ransac(p3[:240], uv[:240], K, method="iterative", ransac=False)
    assert rot_deg(got[:, :3], want[:, :3]) < ITER_DEG
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=ITER_M)
    assert pnp.pnp_ransac(p3[:3], uv[:3], K) is None
    got, want = (f(p3, uv, K, method="p3p", ransac=True) for f in (pnp.pnp_ransac, jpnp.pnp_ransac))
    assert epnp_rule(got[:, :3], want[:, :3], R) and got.shape == (3, 4)
    assert np.linalg.norm(got[:, 3] - t) < 0.01
    solved = 0
    for k in range(0, 40, 4):  # P3P without RANSAC: 4 points; some sets have no root
        got, want = (f(p3[k:k + 4], uv[k:k + 4], K, method="p3p", ransac=False)
                     for f in (pnp.pnp_ransac, jpnp.pnp_ransac))
        assert (got is None) == (want is None)
        if want is not None:
            solved += 1
            assert rot_deg(got[:, :3], want[:, :3]) < P3P_DEG
            np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=P3P_M)
    assert solved >= 5
    for f in (pnp.pnp_ransac, jpnp.pnp_ransac):  # cv2's solvePnP takes 4 points for P3P
        assert f(p3[:5], uv[:5], K, method="p3p", ransac=False) is None

    Rn = (axis_angle(rng, 8.0) @ R).astype(np.float32)
    tn = (t + [0.02, -0.01, 0.02]).astype(np.float32)
    got = pnp.pnp_refine_from_net(Rn, tn, p3[:240], uv[:240], K, pnp_type="iter")
    want = jpnp.pnp_refine_from_net(Rn, tn, p3[:240], uv[:240], K, pnp_type="iter")
    assert rot_deg(got[0], want[0]) < ITER_DEG
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ITER_M)
    got = pnp.pnp_refine_from_net(Rn, tn, p3, uv, K, pnp_type="ransac")
    want = jpnp.pnp_refine_from_net(Rn, tn, p3, uv, K, pnp_type="ransac")
    assert epnp_rule(got[0], want[0], R)
    far = tn + [0.0, 0.0, 2.0]  # the 1 m fallback keeps the net translation
    for ptype in ("iter", "ransac"):
        got = pnp.pnp_refine_from_net(Rn, far, p3, uv, K, pnp_type=ptype)
        want = jpnp.pnp_refine_from_net(Rn, far, p3, uv, K, pnp_type=ptype)
        np.testing.assert_array_equal(got[1], far)
        np.testing.assert_array_equal(want[1], far)
    got = pnp.pnp_refine_from_net(Rn, tn, p3[:3], uv[:3], K)
    assert got[0] is Rn and got[1] is tn


@pytest.mark.parametrize("mode", ["ransac_pnp", "net_iter_pnp", "net_ransac_pnp"])
def test_refine_bucket_poses_host_equals_jax(mode):
    cfg, models, batch, out, R, t = bucket(12)
    cfg.TEST.DEVICE_PNP = False
    cfg.TEST.PNP_TYPE = mode
    (Rp, tp), (Rj, tj) = refine_both(cfg, models, batch, out)
    assert Rp.dtype == np.float32 and Rp.shape == (4, 3, 3)
    for j in range(3):
        if mode == "net_iter_pnp":
            assert rot_deg(Rp[j], Rj[j]) < ITER_DEG
            np.testing.assert_allclose(tp[j], tj[j], rtol=0, atol=ITER_M)
        else:
            assert epnp_rule(Rp[j], Rj[j], R[j])
            assert np.linalg.norm(tp[j] - t[j]) < 0.01
    np.testing.assert_array_equal(Rp[3], out["rot"][3])  # padding keeps the net pose
    np.testing.assert_array_equal(tp[3], out["trans"][3])
