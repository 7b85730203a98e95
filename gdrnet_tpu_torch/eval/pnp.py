"""RANSAC / iterative PnP refinement from predicted dense correspondences on
the host (counterpart of gdrnet_tpu/eval/pnp.py, on the numpy stand-ins of
eval/cv_pnp.py instead of cv2).

The reference's three test-time post-processing modes (gdrn_evaluator.py):
  * the net pose, no PnP (process :128-185), handled by the tester;
  * the net pose refined by iterative or RANSAC EPnP (process_net_and_pnp
    :187-314);
  * pure RANSAC-EPnP (process_pnp_ransac :316-435, misc.pnp_v2 :145).

Correspondences come from the predicted XYZ map and mask
(get_img_model_points_with_coords2d :89-126): the crop pixels whose mask
prob > thr and |xyz| > 1e-4 * extent on every axis, with xyz back in object
metres and the crop's 2D coordinate map in image pixels. This is the
per-ROI host loop; TEST.DEVICE_PNP runs the bucket on the device instead
(ops/device_pnp.py).
"""

from __future__ import annotations

import numpy as np

from gdrnet_tpu_torch.eval import cv_pnp


def correspondences_from_maps(mask_prob: np.ndarray, xyz_norm: np.ndarray,
                              coord2d: np.ndarray, im_w: int, im_h: int,
                              extent: np.ndarray, mask_thr: float = 0.5,
                              max_num_points: int = -1,
                              rng: np.random.RandomState | None = None):
    """mask_prob [H,W]; xyz_norm [H,W,3] in [0,1]; coord2d [H,W,2] in [0,1]
    (fractions of the full image, the test mapper's roi_coord_2d). Returns
    (image_points [N,2], model_points [N,3]); with max_num_points >= 4, a
    random subset of that many (np.random.RandomState(0) unless `rng`)."""
    xyz = (np.asarray(xyz_norm, np.float64) - 0.5) * np.asarray(extent, np.float64)
    img_pts = np.asarray(coord2d, np.float64) * np.asarray([im_w, im_h], np.float64)
    sel = (
        (np.asarray(mask_prob) > mask_thr)
        & (np.abs(xyz[..., 0]) > 1e-4 * extent[0])
        & (np.abs(xyz[..., 1]) > 1e-4 * extent[1])
        & (np.abs(xyz[..., 2]) > 1e-4 * extent[2])
    )
    model_points = xyz[sel].reshape(-1, 3)
    image_points = img_pts[sel].reshape(-1, 2)
    if max_num_points >= 4 and len(image_points) > max_num_points:
        rng = rng or np.random.RandomState(0)
        idx = rng.permutation(len(image_points))[:max_num_points]
        model_points, image_points = model_points[idx], image_points[idx]
    return image_points, model_points


def pnp_ransac(model_points: np.ndarray, image_points: np.ndarray,
               K: np.ndarray, method: str = "epnp", ransac: bool = True,
               reproj_err: float = 3.0, iterations: int = 100) -> np.ndarray | None:
    """Pure PnP (misc.pnp_v2, lib/pysixd/misc.py:145-196). Returns the [3,4]
    pose, or None on failure. method: epnp, iterative, p3p (RANSAC over
    minimal sets of 4 refit by EPnP; without RANSAC exactly 4 points, as
    cv2's solvePnP takes, else None), or dls (EPnP, as getattr(cv2,
    "SOLVEPNP_DLS", cv2.SOLVEPNP_EPNP) gives in cv2 5.0)."""
    if len(model_points) < 4:
        return None
    flags = {"epnp": "epnp", "iterative": "iterative", "p3p": "p3p", "dls": "epnp"}[method]
    p3 = np.ascontiguousarray(model_points, np.float64)
    p2 = np.ascontiguousarray(image_points, np.float64)
    try:
        if ransac:
            ok, rvec, tvec, _ = cv_pnp.solve_pnp_ransac(
                p3, p2, K, flags=flags, reprojection_error=reproj_err,
                iterations_count=iterations)
        else:
            ok, rvec, tvec = cv_pnp.solve_pnp(p3, p2, K, flags=flags)
    except cv_pnp.PnPError:
        return None
    if not ok:
        return None
    return np.concatenate([cv_pnp.rodrigues(rvec), np.asarray(tvec).reshape(3, 1)], axis=-1)


def pnp_refine_from_net(rot_net: np.ndarray, trans_net: np.ndarray,
                        model_points: np.ndarray, image_points: np.ndarray,
                        K: np.ndarray, pnp_type: str = "iter",
                        reproj_err: float = 3.0, iterations: int = 20
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Net-initialised refinement (process_net_and_pnp, gdrn_evaluator.py
    :255-296): solvePnP ITERATIVE, or solvePnPRansac with EPnP, from the net
    pose; the net translation stays where |dt| > 1 m (:293-296)."""
    if len(model_points) < 4:
        return rot_net, trans_net
    p3 = np.ascontiguousarray(model_points, np.float64)
    p2 = np.ascontiguousarray(image_points, np.float64)
    rvec0 = cv_pnp.rodrigues(np.asarray(rot_net, np.float64))
    tvec0 = np.asarray(trans_net, np.float64).reshape(3, 1).copy()
    try:
        if pnp_type == "ransac":
            ok, rvec, tvec, _ = cv_pnp.solve_pnp_ransac(
                p3, p2, K, flags="epnp", use_extrinsic_guess=True, rvec=rvec0, tvec=tvec0,
                reprojection_error=reproj_err, iterations_count=iterations)
        else:
            ok, rvec, tvec = cv_pnp.solve_pnp(p3, p2, K, flags="iterative", rvec=rvec0,
                                              tvec=tvec0, use_extrinsic_guess=True)
    except cv_pnp.PnPError:
        return rot_net, trans_net
    if not ok:
        return rot_net, trans_net
    R = cv_pnp.rodrigues(rvec)
    t = np.asarray(tvec).reshape(3)
    if np.linalg.norm(t - trans_net) > 1.0:  # te > 1 m fallback
        t = trans_net
    return R, t
