"""Synthetic fixed-shape ROI batches (numpy), channels-last.

A copy of gdrnet_tpu/data/synthetic.py:synthetic_roi_batch, which cannot be
imported without JAX (gdrnet_tpu.data's package import pulls it in). The
two must stay equal; tests/test_torch_slice.py holds them to it.
"""

from __future__ import annotations

import numpy as np


def _random_rotations(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform random rotations via QR of gaussian matrices."""
    A = rng.randn(n, 3, 3)
    Q, R = np.linalg.qr(A)
    d = np.sign(np.diagonal(R, axis1=-2, axis2=-1))
    Q = Q * d[:, None, :]
    det = np.linalg.det(Q)
    Q[:, :, 0] *= det[:, None]
    return Q.astype(np.float32)


def synthetic_roi_batch(batch_size: int = 8, input_res: int = 256,
                        out_res: int = 64, num_classes: int = 13,
                        num_points: int = 512, num_regions: int = 8,
                        sym_k: int = 4, seed: int = 0,
                        img_w: int = 640, img_h: int = 480) -> dict:
    """Returns a dict of numpy arrays (channels-last) covering every input
    of the GDRN train step."""
    rng = np.random.RandomState(seed)
    B = batch_size

    K = np.tile(np.asarray(
        [[572.4114, 0, 325.2611], [0, 573.5704, 242.0490], [0, 0, 1]],
        np.float32), (B, 1, 1))

    rot = _random_rotations(rng, B)
    z = rng.uniform(0.5, 1.2, B).astype(np.float32)
    cx = rng.uniform(200, 440, B).astype(np.float32)
    cy = rng.uniform(140, 340, B).astype(np.float32)
    tx = (cx - K[:, 0, 2]) * z / K[:, 0, 0]
    ty = (cy - K[:, 1, 2]) * z / K[:, 1, 1]
    trans = np.stack([tx, ty, z], axis=1)

    # DZI-style square ROI: center jittered off centroid, scale ~ bbox*1.5
    bw = rng.uniform(64, 160, B).astype(np.float32)
    bh = rng.uniform(64, 160, B).astype(np.float32)
    bx = cx + rng.uniform(-0.1, 0.1, B).astype(np.float32) * bw
    by = cy + rng.uniform(-0.1, 0.1, B).astype(np.float32) * bh
    scale = (np.maximum(bw, bh) * 1.5).astype(np.float32)
    resize_ratio = (out_res / scale).astype(np.float32)

    # SITE targets (reference data_loader.py:628-632)
    trans_ratio = np.stack(
        [(cx - bx) / bw, (cy - by) / bh, z / resize_ratio], axis=1).astype(np.float32)

    extents = rng.uniform(0.05, 0.15, (B, 3)).astype(np.float32)
    points = (rng.rand(B, num_points, 3).astype(np.float32) - 0.5) * extents[:, None, :]
    fps = (rng.rand(B, num_regions, 3).astype(np.float32) - 0.5) * extents[:, None, :]

    # blocky object mask in the center of the 64x64 ROI + consistent labels
    ys, xs = np.mgrid[0:out_res, 0:out_res]
    masks = np.zeros((B, out_res, out_res), np.float32)
    xyz = np.zeros((B, out_res, out_res, 3), np.float32)
    region = np.zeros((B, out_res, out_res), np.int32)
    for i in range(B):
        r = out_res // 4 + rng.randint(0, out_res // 4)
        c0 = out_res // 2 + rng.randint(-4, 4)
        m = ((np.abs(ys - c0) < r) & (np.abs(xs - c0) < r)).astype(np.float32)
        masks[i] = m
        # fake normalized xyz in [0,1] inside the mask
        g = np.stack([xs / out_res, ys / out_res,
                      0.5 + 0.2 * np.sin(xs / 7.0)], axis=-1).astype(np.float32)
        xyz[i] = g * m[..., None]
        # region = nearest fps point of the denormalized coords
        coords = (xyz[i] - 0.5) * extents[i]
        d = np.linalg.norm(coords[..., None, :] - fps[i][None, None], axis=-1)
        region[i] = (np.argmin(d, axis=-1) + 1) * m.astype(np.int32)

    xyz_bin = np.clip((xyz * 64).astype(np.int32), 0, 63)

    sym_rots = np.tile(np.eye(3, dtype=np.float32), (B, sym_k, 1, 1))
    sym_mask = np.zeros((B, sym_k), bool)
    sym_mask[:, 0] = True

    coord2d = np.stack(np.meshgrid(
        np.linspace(0, 1, out_res, dtype=np.float32),
        np.linspace(0, 1, out_res, dtype=np.float32)), axis=-1)

    return {
        "roi_img": rng.rand(B, input_res, input_res, 3).astype(np.float32),
        "roi_classes": rng.randint(0, num_classes, B).astype(np.int32),
        "roi_coord_2d": np.tile(coord2d[None], (B, 1, 1, 1)),
        "roi_cams": K,
        "roi_centers": np.stack([bx, by], axis=1),
        "roi_whs": np.stack([bw, bh], axis=1),
        "roi_extents": extents,
        "resize_ratios": resize_ratio,
        "gt_xyz": xyz,
        "gt_xyz_bin": xyz_bin,
        "gt_mask_trunc": masks,
        "gt_mask_visib": masks,
        "gt_mask_obj": masks,
        "gt_region": region,
        "gt_ego_rot": rot,
        "gt_trans": trans,
        "gt_trans_ratio": trans_ratio,
        "gt_points": points,
        "sym_rots": sym_rots,
        "sym_mask": sym_mask,
    }


# ---------------------------------------------------------------------------
# scoring fixtures (port only): object models and GT poses near predictions
# ---------------------------------------------------------------------------


def _axis_angle(axes: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rodrigues for [n, 3] unit axes and [n] angles -> [n, 3, 3]."""
    K = np.zeros((len(axes), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axes[:, 2], axes[:, 1], -axes[:, 0]
    K = K - np.transpose(K, (0, 2, 1))
    s, c = np.sin(angles)[:, None, None], np.cos(angles)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def synthetic_object_models(obj_names: list[str], sym_objs: list[str],
                            num_points: int = 3000, seed: int = 0):
    """Box-shaped objects for the evaluator: per object `num_points` points
    [N, 3] in metres, its diameter, and for each symmetric object a discrete
    k-fold symmetry about z as [k-1, 3, 3], k cycling through 2, 4, 2, 2 (the
    folds of brick, tower, bar and hexprism in tools/gen_scale_dataset.py).
    Returns (model_points, diameters, sym_rots) dicts."""
    rng = np.random.RandomState(seed)
    points, diameters, sym_rots = {}, {}, {}
    for name in obj_names:
        extent = rng.uniform(0.05, 0.2, 3)
        points[name] = ((rng.rand(num_points, 3) - 0.5) * extent).astype(np.float32)
        diameters[name] = float(np.linalg.norm(extent))
    for i, name in enumerate(sym_objs):
        k = (2, 4, 2, 2)[i % 4]
        angles = 2 * np.pi * np.arange(1, k) / k
        sym_rots[name] = _axis_angle(np.tile([[0.0, 0.0, 1.0]], (k - 1, 1)),
                                     angles).astype(np.float32)
    return points, diameters, sym_rots


def poses_near(R: np.ndarray, t: np.ndarray, seed: int = 0, max_deg: float = 15.0,
               t_sigma: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
    """GT poses scattered around [B,3,3] / [B,3] poses: a rotation by up to
    max_deg about a random axis and gaussian translation noise (metres), so
    that every recall threshold sees poses on both sides of it."""
    rng = np.random.RandomState(seed)
    B = len(R)
    axes = rng.randn(B, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dR = _axis_angle(axes, np.deg2rad(rng.uniform(0, max_deg, B)))
    R_gt = (np.asarray(R, np.float64) @ dR).astype(np.float32)
    t_gt = (np.asarray(t, np.float64) + rng.randn(B, 3) * t_sigma).astype(np.float32)
    return R_gt, t_gt
