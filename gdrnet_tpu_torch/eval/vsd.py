"""Visible Surface Discrepancy (VSD) on tensors, batched over pairs
(counterpart of gdrnet_tpu/eval/vsd.py:24-250, with the silhouette
errors cus and cou_bb_proj). Depths render through
ops.rasterizer, so on a CUDA `device` every render is a launch of the
z-buffer kernel (reference lib/pysixd/pose_error.vsd:22-129 renders with
external C++/GL renderers).

Per pair:
  render depth(est pose), depth(gt pose) -> distance images
  visib_gt  = (d_gt>0)  & (d_gt - d_test <= delta | d_test==0)   [bop19]
  visib_est = ((d_est>0) & (d_est - d_test <= delta | d_test==0))
              | (visib_gt & d_est>0)
  e(tau) = (#(|d_gt-d_est| >= tau on inter) + #(union \\ inter)) / #union
"""

from __future__ import annotations

import numpy as np
import torch

from gdrnet_tpu_torch.eval.pose_errors import cou_bb_batch, cou_mask_batch
from gdrnet_tpu_torch.ops.rasterizer import (
    paste_window,
    render_xyz_roi_many,
    render_xyz_windows,
)

BOP19_TAUS = np.arange(0.05, 0.51, 0.05)


def depth_to_dist(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth (Z) images [P,H,W] with intrinsics [P,3,3] -> distance-from-
    camera-center images (misc.depth_im_to_dist_im_fast,
    lib/pysixd/misc.py:571-590)."""
    _, h, w = depth.shape
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)
    xn = (xs[None, None, :] - K[:, 0, 2, None, None]) / K[:, 0, 0, None, None]
    yn = (ys[None, :, None] - K[:, 1, 2, None, None]) / K[:, 1, 1, None, None]
    return depth * torch.sqrt(xn * xn + yn * yn + 1.0)


def _visib_mask(d_test, d_model, delta: float, mode: str = "bop19") -> torch.Tensor:
    d_diff = d_model - d_test
    if mode == "bop18":
        return (d_test > 0) & (d_model > 0) & (d_diff <= delta)
    return ((d_diff <= delta) | (d_test == 0)) & (d_model > 0)


def estimate_visib_mask_gt(d_test, d_gt, delta: float, visib_mode: str = "bop19"):
    """Visibility mask of the GT pose render (reference
    lib/pysixd/visibility.py:44-54)."""
    return _visib_mask(d_test, d_gt, delta, visib_mode)


def estimate_visib_mask_est(d_test, d_est, visib_gt, delta: float,
                            visib_mode: str = "bop19"):
    """Visibility mask of the estimated pose render, augmented with pixels
    visible in GT (reference lib/pysixd/visibility.py:57-71)."""
    return _visib_mask(d_test, d_est, delta, visib_mode) | (visib_gt & (d_est > 0))


def vsd_from_depths(depth_est, depth_gt, depth_test, K, delta: float, taus, diameter: float,
                    normalized_by_diameter: bool = True, cost_type: str = "step",
                    visib_mode: str = "bop19") -> torch.Tensor:
    """Depths [P,H,W] (metres), K [P,3,3], taus [T] -> [P,T] errors; a pair
    whose union of visible pixels is empty scores 1."""
    d_test = depth_to_dist(depth_test, K)
    d_gt = depth_to_dist(depth_gt, K)
    d_est = depth_to_dist(depth_est, K)
    visib_gt = _visib_mask(d_test, d_gt, delta, visib_mode)
    visib_est = _visib_mask(d_test, d_est, delta, visib_mode) | (visib_gt & (d_est > 0))

    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    union_count = union.sum(dim=(1, 2))                                 # [P]
    comp_count = union_count - inter.sum(dim=(1, 2))
    dists = (d_gt - d_est).abs()
    if normalized_by_diameter:
        dists = dists / diameter
    taus = torch.as_tensor(np.asarray(taus, np.float32), device=dists.device)
    errs = []
    for tau in taus:
        if cost_type == "step":
            cost = ((dists >= tau) & inter).sum(dim=(1, 2))
        else:  # tlinear
            cost = ((dists / tau).clamp(0.0, 1.0) * inter).sum(dim=(1, 2))
        errs.append((cost + comp_count).float() / union_count.clamp_min(1).float())
    errs = torch.stack(errs, dim=1)
    return torch.where((union_count == 0)[:, None], torch.ones_like(errs), errs)


def render_depths_many(verts, faces, Ks, Rs, ts, height: int, width: int, device="cuda"
                       ) -> torch.Tensor:
    """[N,H,W] full-frame depths on `device`: windows of 128, 256 and 512
    pixels for the poses whose projection fits one (render_xyz_roi_many),
    pasted into the frame; the rest as full frames, all in one render."""
    Ks = np.asarray(Ks, np.float32)
    Rs = np.asarray(Rs, np.float32)
    ts = np.asarray(ts, np.float32)
    depths = torch.zeros(len(Rs), height, width, dtype=torch.float32, device=device)
    remaining = list(range(len(Rs)))
    for tile in (128, 256, 512):
        if not remaining or tile > min(height, width):
            break
        idx = np.asarray(remaining)
        outs, fitted = render_xyz_roi_many(verts, faces, Ks[idx], Rs[idx], ts[idx], height,
                                           width, tile=tile, on_misfit="skip", device=device)
        for (d_win, _, org), k in zip(outs, fitted):
            paste_window(depths[int(idx[k])], d_win, org)
        fitted_set = set(fitted)
        remaining = [i for k, i in enumerate(remaining) if k not in fitted_set]
    if remaining:
        depths[remaining] = render_xyz_windows(
            verts, faces, Ks[remaining], Rs[remaining], ts[remaining],
            np.zeros((len(remaining), 2), np.float32), height, width, device)[0]
    return depths


def vsd_pairs(R_est, t_est, R_gt, t_gt, depth_tests, Ks, verts, faces,
              delta: float = 15.0 / 1000.0, taus=None, diameter: float = 0.1,
              normalized_by_diameter: bool = True, cost_type: str = "step",
              device="cuda") -> np.ndarray:
    """Batched VSD for P same-object pairs -> [P, T] errors (numpy). Renders
    the est and gt depths of all pairs together, then evaluates every pair
    at once on `device`."""
    taus = BOP19_TAUS if taus is None else taus
    depth_tests = torch.as_tensor(np.asarray(depth_tests, np.float32), device=device)
    p, h, w = depth_tests.shape
    Rall = np.concatenate([np.asarray(R_est, np.float32), np.asarray(R_gt, np.float32)])
    tall = np.concatenate([np.asarray(t_est, np.float32), np.asarray(t_gt, np.float32)])
    Ks = np.asarray(Ks, np.float32)
    depths = render_depths_many(verts, faces, np.concatenate([Ks, Ks]), Rall, tall, h, w,
                                device=device)
    errs = vsd_from_depths(depths[:p], depths[p:], depth_tests,
                           torch.as_tensor(Ks, device=device), delta, taus, diameter,
                           normalized_by_diameter, cost_type)
    return errs.cpu().numpy()


def vsd(R_est, t_est, R_gt, t_gt, depth_test, K, verts, faces,
        delta: float = 15.0 / 1000.0, taus=None, diameter: float = 0.1,
        normalized_by_diameter: bool = True, cost_type: str = "step",
        device="cuda") -> np.ndarray:
    """Full VSD for one estimate -> [T] errors. depth_test in metres (BOP
    depth png / depth_scale / 1000). Default delta=15mm, taus=0.05..0.5 step
    0.05 (BOP19)."""
    return vsd_pairs(np.asarray(R_est)[None], np.asarray(t_est)[None], np.asarray(R_gt)[None],
                     np.asarray(t_gt)[None], np.asarray(depth_test)[None],
                     np.asarray(K)[None], verts, faces, delta, taus, diameter,
                     normalized_by_diameter, cost_type, device)[0]


def _depth_pair(R_est, t_est, R_gt, t_gt, K, verts, faces, height: int, width: int,
                device) -> torch.Tensor:
    """Full-frame depths [2, H, W] of the mesh at the estimated and the GT
    pose, in one render_xyz_windows call (one B2 launch on CUDA)."""
    Rs = np.stack([np.asarray(R_est, np.float32), np.asarray(R_gt, np.float32)])
    ts = np.stack([np.asarray(t_est, np.float32).reshape(3),
                   np.asarray(t_gt, np.float32).reshape(3)])
    Ks = np.stack([np.asarray(K, np.float32)] * 2)
    return render_xyz_windows(verts, faces, Ks, Rs, ts, np.zeros((2, 2), np.float32),
                              height, width, device)[0]


def cus(R_est, t_est, R_gt, t_gt, K, verts, faces, height: int = 480, width: int = 640,
        device="cuda") -> float:
    """Complement over union of the projected silhouettes (reference
    pose_error.py:487-532; gdrnet_tpu/eval/vsd.py:211-226)."""
    d = _depth_pair(R_est, t_est, R_gt, t_gt, K, verts, faces, height, width, device)
    return float(cou_mask_batch((d[0] > 0)[None], (d[1] > 0)[None])[0])


def cou_bb_proj(R_est, t_est, R_gt, t_gt, K, verts, faces, height: int = 480,
                width: int = 640, device="cuda") -> float:
    """Complement over union of the projected silhouettes' xywh boxes,
    unclipped (reference pose_error.py:545-590; gdrnet_tpu/eval/vsd.py:229-250)."""
    masks = (_depth_pair(R_est, t_est, R_gt, t_gt, K, verts, faces, height, width, device)
             > 0).cpu().numpy()

    def bb_of(mask):
        ys, xs = np.nonzero(mask)
        if len(xs) == 0:
            return np.zeros(4, np.float32)
        return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                         ys.max() - ys.min() + 1], np.float32)

    return float(cou_bb_batch(torch.from_numpy(bb_of(masks[0]))[None],
                              torch.from_numpy(bb_of(masks[1]))[None])[0])
