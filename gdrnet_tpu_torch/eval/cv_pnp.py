"""numpy stand-ins for the OpenCV calls of the host PnP path, which the
card's machine cannot make (it has no cv2): Rodrigues, solvePnP with
SOLVEPNP_EPNP, SOLVEPNP_ITERATIVE and SOLVEPNP_P3P, and solvePnPRansac,
with no lens distortion (the callers pass zeros). tests/test_torch_cv_pnp.py
holds each against cv2 5.0.

* rodrigues: cv2.Rodrigues's formulas in both directions (the matrix is
  orthonormalised by its SVD first, as cv2 does).
* solve_pnp(flags="epnp"): calib3d's epnp.cpp in double: PCA control
  points, barycentric coordinates, the null space of M^T M, the three beta
  approximations, 5 Gauss-Newton steps each, the pose of least mean
  reprojection error. cv2 solves Gauss-Newton's 6x4 system by a Householder
  QR; here it is numpy's least squares.
* solve_pnp(flags="iterative"): cvFindExtrinsicCameraParams2's
  Levenberg-Marquardt (CvLevMarq: lambda 10^-3, 20 iterations, a relative
  step below FLT_EPSILON ends it) on the reprojection error over
  (rvec, tvec), from the extrinsic guess or, without one, from where cv2
  starts: the DLT of the 3x4 pose (non-planar points, at least 6) or the
  homography of the points' plane (here the normalised DLT without
  findHomography's own LM polish).
* solve_pnp(flags="p3p"): solveP3P on exactly 4 points: every positive root
  of the first three (the laws of cosines reduced to a quartic, polished to
  the last bits), the pose of least squared reprojection error over all
  four.
* solve_pnp_ransac: the point-set registrator of ptsetreg.cpp with cv2's
  own random stream (cv::RNG seeded with 2^64 - 1, so each call draws cv2's
  subsets), minimal sets of 5 solved by EPnP (of 4 by P3P with P3P flags)
  on the points rounded to f32 as cv2 rounds them, inliers at squared f32
  error <= threshold^2, the adaptive iteration count for confidence 0.99,
  then a refit on the inliers with `flags` (EPnP for EPnP and P3P, or LM
  from the best model). A set of exactly 4 points is one P3P solve, as in
  cv2, whatever the flags.

SOLVEPNP_AP3P, SQPNP, IPPE and cv2's other solvers raise
NotImplementedError: no path of the JAX package reaches them.
"""

from __future__ import annotations

import math

import numpy as np

FLT_EPSILON = float(np.finfo(np.float32).eps)
DBL_EPSILON = float(np.finfo(np.float64).eps)
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_NOT_REACHED = "not ported: no path of the JAX package reaches this cv2 solver"


class PnPError(ValueError):
    """What cv2 raises as cv2.error: too few points, or arrays of the wrong shape."""


def _skew(v) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def rodrigues(src) -> np.ndarray:
    """A rotation vector (3 values) -> its 3x3 matrix; a 3x3 matrix -> its
    rotation vector [3, 1] (cv2.Rodrigues, without the Jacobian)."""
    src = np.asarray(src, np.float64)
    if src.size == 3:
        r = src.reshape(3)
        theta = math.sqrt(float(r @ r))
        if theta < DBL_EPSILON:
            return np.eye(3)
        c, s = math.cos(theta), math.sin(theta)
        k = r / theta
        return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * _skew(k)
    if src.shape != (3, 3):
        raise PnPError(f"rodrigues: expected 3 values or a 3x3 matrix, got {src.shape}")
    U, _, Vt = np.linalg.svd(src)
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = math.sqrt(float(r @ r) * 0.25)
    c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0), 1.0)
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            r = np.zeros(3)
        else:
            r = np.array([math.sqrt(max((R[0, 0] + 1.0) * 0.5, 0.0)),
                          math.sqrt(max((R[1, 1] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0),
                          math.sqrt(max((R[2, 2] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)])
            if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                    and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
                r[2] = -r[2]
            r = r * (theta / math.sqrt(float(r @ r)))
    else:
        r = r * (theta / (2.0 * s))
    return r.reshape(3, 1)


def _rotation_and_jacobian(r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """R(r) and dR/dr_k [3, 3, 3] (Gallego and Yezzi's closed form; [e_k]x
    at r = 0)."""
    R = rodrigues(r)
    theta2 = float(r @ r)
    if theta2 < DBL_EPSILON * DBL_EPSILON:
        return R, np.stack([_skew(e) for e in np.eye(3)])
    eye = np.eye(3)
    dR = [(r[k] * _skew(r) + _skew(np.cross(r, (eye - R)[:, k]))) / theta2 @ R for k in range(3)]
    return R, np.stack(dR)


def _camera(K) -> tuple[float, float, float, float]:
    K = np.asarray(K, np.float64)
    if K.shape != (3, 3):
        raise PnPError(f"camera matrix must be 3x3, got {K.shape}")
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def _points(object_points, image_points) -> tuple[np.ndarray, np.ndarray]:
    p3 = np.asarray(object_points)
    p2 = np.asarray(image_points)
    if p3.size % 3 or p2.size % 2 or p3.size // 3 != p2.size // 2:
        raise PnPError(f"object points {p3.shape} and image points {p2.shape} do not pair")
    return p3.reshape(-1, 3), p2.reshape(-1, 2)


# ---------------------------------------------------------------------------
# EPnP (calib3d epnp.cpp)
# ---------------------------------------------------------------------------


def _svd_solve(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv::solve(DECOMP_SVD): the SVD back-substitution that drops singular
    values below 2 * DBL_EPSILON * their sum."""
    U, w, Vt = np.linalg.svd(A, full_matrices=False)
    keep = np.abs(w) > 2.0 * DBL_EPSILON * w.sum()
    c = np.where(keep, (U.T @ b) / np.where(keep, w, 1.0), 0.0)
    return Vt.T @ c


def _betas(L: np.ndarray, rho: np.ndarray) -> list[np.ndarray]:
    """find_betas_approx_1, _2 and _3."""
    b4 = _svd_solve(L[:, [0, 1, 3, 6]], rho)
    if b4[0] < 0:
        b0 = math.sqrt(-b4[0])
        betas1 = np.array([b0, -b4[1] / b0, -b4[2] / b0, -b4[3] / b0])
    else:
        b0 = math.sqrt(b4[0])
        betas1 = np.array([b0, b4[1] / b0, b4[2] / b0, b4[3] / b0]) if b0 else np.full(4, np.nan)
    out = [betas1]
    for cols in ([0, 1, 2], [0, 1, 2, 3, 4]):
        b = _svd_solve(L[:, cols], rho)
        if b[0] < 0:
            bt = [math.sqrt(-b[0]), math.sqrt(-b[2]) if b[2] < 0 else 0.0]
        else:
            bt = [math.sqrt(b[0]), math.sqrt(b[2]) if b[2] > 0 else 0.0]
        if b[1] < 0:
            bt[0] = -bt[0]
        third = (b[3] / bt[0] if bt[0] else np.nan) if len(cols) == 5 else 0.0
        out.append(np.array([bt[0], bt[1], third, 0.0]))
    return out


def _gauss_newton(L: np.ndarray, rho: np.ndarray, betas: np.ndarray) -> np.ndarray:
    for _ in range(5):
        b = betas
        A = np.stack([
            2 * L[:, 0] * b[0] + L[:, 1] * b[1] + L[:, 3] * b[2] + L[:, 6] * b[3],
            L[:, 1] * b[0] + 2 * L[:, 2] * b[1] + L[:, 4] * b[2] + L[:, 7] * b[3],
            L[:, 3] * b[0] + L[:, 4] * b[1] + 2 * L[:, 5] * b[2] + L[:, 8] * b[3],
            L[:, 6] * b[0] + L[:, 7] * b[1] + L[:, 8] * b[2] + 2 * L[:, 9] * b[3]], 1)
        quad = np.array([b[0] * b[0], b[0] * b[1], b[1] * b[1], b[0] * b[2], b[1] * b[2],
                         b[2] * b[2], b[0] * b[3], b[1] * b[3], b[2] * b[3], b[3] * b[3]])
        betas = betas + np.linalg.lstsq(A, rho - L @ quad, rcond=None)[0]
    return betas


def _epnp(pws: np.ndarray, us: np.ndarray, cam) -> tuple[np.ndarray, np.ndarray]:
    """pws [n, 3] and pixels us [n, 2] in double -> (R, t)."""
    fu, fv, uc, vc = cam
    n = len(pws)
    c0 = pws.sum(0) / n
    PW0 = pws - c0
    Uc, dc, _ = np.linalg.svd(PW0.T @ PW0)
    cws = np.stack([c0] + [c0 + math.sqrt(dc[i] / n) * Uc[:, i] for i in range(3)])
    CC = (cws[1:] - c0).T                      # columns c_j - c0
    a123 = PW0 @ np.linalg.pinv(CC).T
    alphas = np.concatenate([1.0 - a123.sum(1, keepdims=True), a123], 1)  # [n, 4]
    M = np.zeros((2 * n, 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - us[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - us[:, 1:])
    _, _, ut = np.linalg.svd(M.T @ M)          # rows: singular vectors, descending
    v = [ut[11 - i].reshape(4, 3) for i in range(4)]
    dv = np.stack([[vi[a] - vi[b] for a, b in _PAIRS] for vi in v])  # [4, 6, 3]
    d = lambda i, j: (dv[i] * dv[j]).sum(1)    # noqa: E731
    L = np.stack([d(0, 0), 2 * d(0, 1), d(1, 1), 2 * d(0, 2), 2 * d(1, 2), d(2, 2),
                  2 * d(0, 3), 2 * d(1, 3), 2 * d(2, 3), d(3, 3)], 1)
    rho = np.array([((cws[a] - cws[b]) ** 2).sum() for a, b in _PAIRS])
    best = None
    for betas in _betas(L, rho):
        betas = _gauss_newton(L, rho, betas)
        ccs = sum(betas[i] * v[i] for i in range(4))
        pcs = alphas @ ccs
        if pcs[0, 2] < 0:                      # solve_for_sign: the first point
            pcs = -pcs
        pc0, pw0 = pcs.mean(0), pws.mean(0)
        Ua, _, Vat = np.linalg.svd((pcs - pc0).T @ (pws - pw0))
        R = Ua @ Vat
        if np.linalg.det(R) < 0:
            R[2] = -R[2]
        t = pc0 - R @ pw0
        pc = pws @ R.T + t
        err = np.mean(np.hypot(us[:, 0] - (uc + fu * pc[:, 0] / pc[:, 2]),
                               us[:, 1] - (vc + fv * pc[:, 1] / pc[:, 2])))
        if best is None or err < best[0]:      # the first of equal errors
            best = (err, R, t)
    return best[1], best[2]


def _normalized_pixels(p2: np.ndarray, cam, dtype) -> np.ndarray:
    """undistortPoints without distortion, stored in `dtype` as cv2 stores
    it (the input's), then back to pixels as epnp's init_points does."""
    fu, fv, uc, vc = cam
    x = ((p2[:, 0] - uc) * (1.0 / fu)).astype(dtype).astype(np.float64)
    y = ((p2[:, 1] - vc) * (1.0 / fv)).astype(dtype).astype(np.float64)
    return np.stack([x * fu + uc, y * fv + vc], 1)


def _solve_epnp(p3: np.ndarray, p2: np.ndarray, cam) -> tuple[np.ndarray, np.ndarray]:
    R, t = _epnp(p3.astype(np.float64), _normalized_pixels(p2, cam, p2.dtype), cam)
    return rodrigues(R), t.reshape(3, 1)


# ---------------------------------------------------------------------------
# P3P (solveP3P: the roots of three points, sorted by the error on all four)
# ---------------------------------------------------------------------------


def _p3p_distances(f: np.ndarray, pw: np.ndarray) -> list[np.ndarray]:
    """Every positive solution (d1, d2, d3) of |d_i f_i - d_j f_j| =
    |P_i - P_j| for unit bearings f [3, 3] and points pw [3, 3].

    With d2 = u d1 and d3 = v d1 the three laws of cosines give u as a ratio
    of polynomials in v and a quartic in v; its real roots are polished by
    Newton steps on the quartic, then (d1, d2, d3) by Newton steps on the
    three equations, to the last bits of the double."""
    P = np.polynomial.polynomial
    c12, c13, c23 = f[0] @ f[1], f[0] @ f[2], f[1] @ f[2]
    D12, D13, D23 = (float(((pw[i] - pw[j]) ** 2).sum()) for i, j in ((0, 1), (0, 2), (1, 2)))
    if min(D12, D13, D23) <= 0:
        return []
    q13 = np.array([1.0, -2 * c13, 1.0])                 # 1 + v^2 - 2 v c13
    N = np.array([D13, 0.0, -D13]) + (D23 - D12) * q13   # u = -N / Dd
    Dd = np.array([-2 * D13 * c12, 2 * D13 * c23])
    Q = np.array([D13, 0.0, 0.0]) - D12 * q13
    quartic = P.polyadd(P.polyadd(D13 * P.polymul(N, N), 2 * D13 * c12 * P.polymul(N, Dd)),
                        P.polymul(Q, P.polymul(Dd, Dd)))
    if not np.isfinite(quartic).all() or np.abs(quartic).max() == 0:
        return []
    roots = np.roots(quartic[::-1])
    scale = max(1.0, np.abs(roots).max(initial=0.0))
    dq = P.polyder(quartic)
    out = []
    for r in roots[np.abs(roots.imag) <= 1e-6 * scale].real:
        for _ in range(4):
            d = P.polyval(r, dq)
            if d == 0:
                break
            r = r - P.polyval(r, quartic) / d
        den = P.polyval(r, Dd)
        if den == 0:
            continue
        u = -P.polyval(r, N) / den
        g = 1.0 + u * u - 2.0 * u * c12
        if u <= 0 or r <= 0 or g <= 0:
            continue
        d = np.sqrt(D12 / g) * np.array([1.0, u, r])
        for _ in range(3):
            e = np.array([d[0] ** 2 + d[1] ** 2 - 2 * d[0] * d[1] * c12 - D12,
                          d[0] ** 2 + d[2] ** 2 - 2 * d[0] * d[2] * c13 - D13,
                          d[1] ** 2 + d[2] ** 2 - 2 * d[1] * d[2] * c23 - D23])
            J = np.array([[2 * d[0] - 2 * d[1] * c12, 2 * d[1] - 2 * d[0] * c12, 0.0],
                          [2 * d[0] - 2 * d[2] * c13, 0.0, 2 * d[2] - 2 * d[0] * c13],
                          [0.0, 2 * d[1] - 2 * d[2] * c23, 2 * d[2] - 2 * d[1] * c23]])
            if abs(np.linalg.det(J)) < 1e-300:
                break
            d = d - np.linalg.solve(J, e)
        if (d > 0).all() and not any(np.allclose(d, o, rtol=1e-9, atol=0) for o in out):
            out.append(d)
    return out


def _kabsch(pw: np.ndarray, pc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The rigid (R, t) that takes pw onto pc in least squares."""
    cw, cc = pw.mean(0), pc.mean(0)
    U, _, Vt = np.linalg.svd((pc - cc).T @ (pw - cw))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    return R, cc - R @ cw


def _solve_p3p(p3: np.ndarray, p2: np.ndarray, cam) -> tuple[np.ndarray, np.ndarray] | None:
    """solvePnP(SOLVEPNP_P3P) on exactly 4 points: every root of the first
    three, the one of least squared reprojection error over all four (the
    first of equal errors), or None where the three give no root."""
    fu, fv, uc, vc = cam
    pix = _normalized_pixels(p2, cam, p2.dtype)
    pw = p3.astype(np.float64)
    rays = np.stack([(pix[:3, 0] - uc) / fu, (pix[:3, 1] - vc) / fv, np.ones(3)], 1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    best = None
    for d in _p3p_distances(rays, pw[:3]):
        R, t = _kabsch(pw[:3], rays * d[:, None])
        pc = pw @ R.T + t
        err = float((((pix - np.stack([uc + fu * pc[:, 0] / pc[:, 2],
                                       vc + fv * pc[:, 1] / pc[:, 2]], 1))) ** 2).sum())
        if best is None or err < best[0]:
            best = (err, R, t)
    if best is None:
        return None
    return rodrigues(best[1]), best[2].reshape(3, 1)


# ---------------------------------------------------------------------------
# ITERATIVE's start without a guess (cvFindExtrinsicCameraParams2)
# ---------------------------------------------------------------------------


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The least-squares homography src -> dst [n, 2] by the normalised DLT
    (findHomography's estimator, without its Levenberg-Marquardt polish)."""
    def norm(p):
        c = p.mean(0)
        s = np.abs(p - c).mean(0)
        s = np.where(s > DBL_EPSILON, 1.0 / np.where(s > DBL_EPSILON, s, 1.0), 0.0)
        return np.array([[s[0], 0, -c[0] * s[0]], [0, s[1], -c[1] * s[1]], [0, 0, 1.0]])

    T1, T2 = norm(src), norm(dst)
    a = np.c_[src, np.ones(len(src))] @ T1.T
    b = np.c_[dst, np.ones(len(dst))] @ T2.T
    L = np.zeros((2 * len(src), 9))
    L[0::2, 0:3], L[0::2, 6:9] = a, -b[:, :1] * a
    L[1::2, 3:6], L[1::2, 6:9] = a, -b[:, 1:2] * a
    H = np.linalg.svd(L)[2][-1].reshape(3, 3)
    H = np.linalg.inv(T2) @ H @ T1
    return H / H[2, 2]


def _initial_extrinsics(p3: np.ndarray, p2: np.ndarray, cam) -> tuple[np.ndarray, np.ndarray]:
    """Where cv2's ITERATIVE starts without a guess: points whose scatter's
    smallest singular value is below 1e-3 of the middle one are planar, and
    start from the homography of their plane; otherwise the DLT of the 3x4
    pose on at least 6 points, projected onto a rotation."""
    fu, fv, uc, vc = cam
    mn = np.stack([(p2[:, 0] - uc) / fu, (p2[:, 1] - vc) / fv], 1)
    M = p3.astype(np.float64)
    Mc = M.mean(0)
    _, W, Vt = np.linalg.svd((M - Mc).T @ (M - Mc))
    if W[2] < 1e-3 * W[1]:
        Rt = Vt.copy()
        if Rt[0, 2] ** 2 + Rt[1, 2] ** 2 < 1e-10:
            Rt = np.eye(3)
        if np.linalg.det(Rt) < 0:
            Rt = -Rt
        Tt = -Rt @ Mc
        H = _homography((M @ Rt.T + Tt)[:, :2], mn)
        n1, n2 = np.linalg.norm(H[:, 0]), np.linalg.norm(H[:, 1])
        h1, h2 = H[:, 0] / max(n1, DBL_EPSILON), H[:, 1] / max(n2, DBL_EPSILON)
        t = H[:, 2] * (2.0 / max(n1 + n2, DBL_EPSILON))
        Rh = rodrigues(rodrigues(np.stack([h1, h2, np.cross(h1, h2)], 1)))
        return rodrigues(Rh @ Rt), (Rh @ Tt + t).reshape(3, 1)
    if len(M) < 6:
        raise PnPError(f"solve_pnp: the DLT start needs at least 6 non-planar points, got {len(M)}")
    L = np.zeros((2 * len(M), 12))
    Mh = np.c_[M, np.ones(len(M))]
    L[0::2, 0:4], L[0::2, 8:12] = Mh, -mn[:, :1] * Mh
    L[1::2, 4:8], L[1::2, 8:12] = Mh, -mn[:, 1:2] * Mh
    RRt = np.linalg.svd(L.T @ L)[2][-1].reshape(3, 4)
    if np.linalg.det(RRt[:, :3]) < 0:
        RRt = -RRt
    sc = np.linalg.norm(RRt[:, :3])
    if sc <= DBL_EPSILON:
        raise PnPError("solve_pnp: degenerate DLT")
    U, _, Vt = np.linalg.svd(RRt[:, :3])
    R = U @ Vt
    return rodrigues(R), (RRt[:, 3] * (np.linalg.norm(R) / sc)).reshape(3, 1)


# ---------------------------------------------------------------------------
# Levenberg-Marquardt (cvFindExtrinsicCameraParams2 with CvLevMarq)
# ---------------------------------------------------------------------------


def _reprojection(param: np.ndarray, p3: np.ndarray, p2: np.ndarray, cam, jacobian: bool):
    """Projection error [2n] (u, v of each point) at (rvec, tvec) = param,
    and its Jacobian [2n, 6]."""
    fu, fv, uc, vc = cam
    R, dR = _rotation_and_jacobian(param[:3])
    pc = p3 @ R.T + param[3:]
    iz = np.where(pc[:, 2] != 0, 1.0 / np.where(pc[:, 2] != 0, pc[:, 2], 1.0), 1.0)
    x, y = pc[:, 0] * iz, pc[:, 1] * iz
    err = np.stack([x * fu + uc - p2[:, 0], y * fv + vc - p2[:, 1]], 1).reshape(-1)
    if not jacobian:
        return err, None
    dpc = np.concatenate([np.einsum("kij,nj->nik", dR, p3),
                          np.broadcast_to(np.eye(3), (len(p3), 3, 3))], 2)  # [n, 3, 6]
    du = fu * iz[:, None] * (dpc[:, 0] - x[:, None] * dpc[:, 2])
    dv = fv * iz[:, None] * (dpc[:, 1] - y[:, None] * dpc[:, 2])
    return err, np.stack([du, dv], 1).reshape(-1, 6)


def _levmarq(p3, p2, cam, rvec, tvec, max_iter: int = 20) -> tuple[np.ndarray, np.ndarray]:
    param = np.concatenate([np.asarray(rvec, np.float64).reshape(3),
                            np.asarray(tvec, np.float64).reshape(3)])
    lam_lg10 = -3
    err, J = _reprojection(param, p3, p2, cam, True)
    prev_norm = float(np.linalg.norm(err))
    iters = 0
    while True:
        JtJ, JtErr = J.T @ J, J.T @ err
        prev = param

        def step(lg10):
            A = JtJ.copy()
            A[np.diag_indices(6)] *= 1.0 + math.exp(lg10 * math.log(10.0))
            return prev - _svd_solve(A, JtErr)

        param = step(lam_lg10)
        while True:
            err_norm = float(np.linalg.norm(_reprojection(param, p3, p2, cam, False)[0]))
            if err_norm > prev_norm:
                lam_lg10 += 1
                if lam_lg10 <= 16:
                    param = step(lam_lg10)
                    continue
            break
        lam_lg10 = max(lam_lg10 - 1, -16)
        iters += 1
        rel = np.linalg.norm(param - prev) / (np.linalg.norm(prev) + DBL_EPSILON)
        if iters >= max_iter or rel < FLT_EPSILON:
            return param[:3].reshape(3, 1), param[3:].reshape(3, 1)
        prev_norm = err_norm
        err, J = _reprojection(param, p3, p2, cam, True)


# ---------------------------------------------------------------------------
# solvePnP / solvePnPRansac
# ---------------------------------------------------------------------------


def solve_pnp(object_points, image_points, K, flags: str = "epnp", rvec=None, tvec=None,
              use_extrinsic_guess: bool = False) -> tuple[bool, np.ndarray, np.ndarray]:
    """cv2.solvePnP(..., flags=SOLVEPNP_EPNP | SOLVEPNP_ITERATIVE |
    SOLVEPNP_P3P) with zero distortion -> (ok, rvec [3, 1], tvec [3, 1]).
    P3P takes exactly 4 points here (cv2 asserts 4 for solvePnP)."""
    p3, p2 = _points(object_points, image_points)
    cam = _camera(K)
    if flags not in ("epnp", "iterative", "p3p"):
        raise NotImplementedError(f"solve_pnp flags={flags!r}: {_NOT_REACHED}")
    if len(p3) < 4:
        raise PnPError(f"solve_pnp: {len(p3)} points, at least 4 are needed")
    if flags == "epnp":
        rv, tv = _solve_epnp(p3, p2, cam)
        return True, rv, tv
    if flags == "p3p":
        if len(p3) != 4:
            raise PnPError(f"solve_pnp: P3P takes 3 or 4 points, got {len(p3)}")
        sol = _solve_p3p(p3, p2, cam)
        return (False, rvec, tvec) if sol is None else (True, *sol)
    if not use_extrinsic_guess:
        rvec, tvec = _initial_extrinsics(p3, p2, cam)
    elif rvec is None or tvec is None:
        raise PnPError("solve_pnp: use_extrinsic_guess needs rvec and tvec")
    rv, tv = _levmarq(p3.astype(np.float64), p2.astype(np.float64), cam, rvec, tvec)
    return True, rv, tv


class _CvRNG:
    """cv::RNG: a multiply-with-carry generator of 64-bit state, seeded as
    RANSACPointSetRegistrator::run seeds it."""

    def __init__(self):
        self.state = (1 << 64) - 1

    def uniform(self, a: int, b: int) -> int:
        if a == b:
            return a
        self.state = ((self.state & 0xFFFFFFFF) * 4164903690 + (self.state >> 32)) & ((1 << 64) - 1)
        return (self.state & 0xFFFFFFFF) % (b - a) + a


def _update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """RANSACUpdateNumIters (ptsetreg.cpp)."""
    p, ep = min(max(p, 0.0), 1.0), min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * -denom else round(num / denom)


def _projection_sq_errors(rvec, tvec, p3f: np.ndarray, p2f: np.ndarray, cam) -> np.ndarray:
    """projectPoints of f32 points into f32 pixels, and the f32 squared
    distance to the f32 image points (PnPRansacCallback::computeError)."""
    fu, fv, uc, vc = cam
    R = rodrigues(rvec)
    pc = p3f.astype(np.float64) @ R.T + np.asarray(tvec, np.float64).reshape(3)
    iz = np.where(pc[:, 2] != 0, 1.0 / np.where(pc[:, 2] != 0, pc[:, 2], 1.0), 1.0)
    proj = np.stack([pc[:, 0] * iz * fu + uc, pc[:, 1] * iz * fv + vc], 1).astype(np.float32)
    d = p2f - proj
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]


def solve_pnp_ransac(object_points, image_points, K, flags: str = "iterative",
                     use_extrinsic_guess: bool = False, rvec=None, tvec=None,
                     iterations_count: int = 100, reprojection_error: float = 8.0):
    """cv2.solvePnPRansac with zero distortion and its default confidence
    0.99 -> (ok, rvec [3, 1], tvec [3, 1], inliers [k, 1] int32 or None)."""
    if flags not in ("epnp", "iterative", "p3p"):
        raise NotImplementedError(f"solve_pnp_ransac flags={flags!r}: {_NOT_REACHED}")
    p3, p2 = _points(object_points, image_points)
    cam = _camera(K)
    n = len(p3)
    if n < 4:
        raise PnPError(f"solve_pnp_ransac: {n} points, at least 4 are needed")
    # cv2 converts double points to float before the registrator
    p3f, p2f = p3.astype(np.float32), p2.astype(np.float32)
    model_points = 4 if n == 4 or flags == "p3p" else 5
    minimal = _solve_p3p if model_points == 4 else _solve_epnp
    if n == model_points:  # cv2: one solvePnP on all points
        sol = minimal(p3f, p2f, cam)
        if sol is None:
            return False, rvec, tvec, None
        return True, *sol, np.arange(n, dtype=np.int32).reshape(-1, 1)

    rng = _CvRNG()
    thr = np.float32(reprojection_error * reprojection_error)
    niters, it, max_good = max(iterations_count, 1), 0, 0
    best = last = None
    while it < niters:
        idx: list[int] = []
        for _ in range(model_points):
            i = rng.uniform(0, n)
            while i in idx:
                i = rng.uniform(0, n)
            idx.append(i)
        it += 1
        model = minimal(p3f[idx], p2f[idx], cam)
        if model is None:  # no root: the iteration counts, nothing is scored
            continue
        last = model
        mask = _projection_sq_errors(*model, p3f, p2f, cam) <= thr
        good = int(mask.sum())
        if good > max(max_good, model_points - 1):
            best, max_good = (model, mask), good
            niters = _update_num_iters(0.99, (n - good) / n, model_points, niters)
    if best is None:
        return False, rvec, tvec, None
    (rv_b, tv_b), mask = best
    p3_in, p2_in = p3f[mask].astype(np.float64), p2f[mask].astype(np.float64)
    if flags in ("epnp", "p3p"):  # cv2 refits a P3P consensus by EPnP
        if len(p3_in) < 4:
            raise PnPError(f"solve_pnp_ransac: {len(p3_in)} inliers, at least 4 are needed")
        rv, tv = _solve_epnp(p3_in, p2_in, cam)
    else:
        # cv2's callback writes each minimal set's pose into the guess it
        # shares, so a guess refit starts from the last minimal set's pose
        start = last if use_extrinsic_guess else (rv_b, tv_b)
        rv, tv = _levmarq(p3_in, p2_in, cam, *start)
    return True, rv, tv, np.flatnonzero(mask).astype(np.int32).reshape(-1, 1)
