"""Pose decode and point transforms on tensors (counterpart of
gdrnet_tpu/ops/pose.py): SITE (centroid + z, relative or absolute), direct
translation, projection and depth back-projection. Rotations come as
[B, 3, 3] matrices or [B, 4] quaternions."""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.ops import rotation as R


def transform_pts(pts: torch.Tensor, rot: torch.Tensor,
                  t: torch.Tensor | None = None) -> torch.Tensor:
    """Apply [..., 3, 3] rotations (and [..., 3] translations) to [..., N, 3]
    points, in full f32 (broadcast multiply-and-sum, as ops.rotation.mm3)."""
    out = (pts[..., :, None, :] * rot[..., None, :, :]).sum(-1)
    return out if t is None else out + t[..., None, :]


def project_points(pts: torch.Tensor, K: torch.Tensor, rot: torch.Tensor | None = None,
                   t: torch.Tensor | None = None) -> torch.Tensor:
    """Project [..., N, 3] points (moved by rot, t first if given) through
    [..., 3, 3] K -> [..., N, 2] pixels; z is floored at 1e-8."""
    if rot is not None:
        pts = transform_pts(pts, rot, t)
    uvw = transform_pts(pts, K)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-8)


def backproject_depth_to_xyz(depth: torch.Tensor, rot: torch.Tensor, t: torch.Tensor,
                             K: torch.Tensor) -> torch.Tensor:
    """Depth map [H, W] and the pose -> object-frame XYZ [H, W, 3]:
    R^T (K^-1 d (u, v, 1) - t), zero where the depth is 0."""
    h, w = depth.shape
    vs, us = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device), indexing="ij")
    uv1 = torch.stack([us.to(depth.dtype), vs.to(depth.dtype), torch.ones_like(depth)], dim=-1)
    cam = depth[..., None] * transform_pts(uv1, torch.linalg.inv(K).to(depth.dtype))
    obj = transform_pts(cam - t.to(depth.dtype), rot.to(depth.dtype).transpose(-1, -2))
    return torch.where(depth[..., None] > 0, obj, 0.0)


def _ego_rotation(pred_rots: torch.Tensor, translation: torch.Tensor, eps: float,
                  is_allo: bool) -> torch.Tensor:
    """[B, 4] quaternions (normalised, then allo -> ego on the quaternion)
    or [B, 3, 3] matrices -> egocentric [B, 3, 3]."""
    if pred_rots.dim() == 2 and pred_rots.shape[-1] == 4:
        q = pred_rots / R.safe_norm(pred_rots, eps=eps)
        return R.quat_to_mat(R.allo_to_ego_quat(translation, q, eps=eps) if is_allo else q)
    if pred_rots.dim() != 3 or pred_rots.shape[-2:] != (3, 3):
        raise ValueError(f"Bad pred_rots shape {tuple(pred_rots.shape)}")
    return R.allo_to_ego_mat(translation, pred_rots, eps=eps) if is_allo else pred_rots


def translation_from_centroid_z(pred_centroids: torch.Tensor, pred_z: torch.Tensor,
                                roi_cams: torch.Tensor, roi_centers: torch.Tensor,
                                resize_ratios: torch.Tensor, roi_whs: torch.Tensor,
                                z_type: str = "REL") -> torch.Tensor:
    """Camera-frame translation [B, 3] from predicted (dx, dy) [B, 2] in
    bbox units and z [B] or [B, 1]:
        cx = dx * bw + bx;  cy = dy * bh + by
        z  = z_rel * resize_ratio (REL) | z_abs (ABS)
        t  = (z (cx - px) / fx,  z (cy - py) / fy,  z)"""
    pred_z = pred_z.reshape(pred_z.shape[0])
    cx = pred_centroids[:, 0] * roi_whs[:, 0] + roi_centers[:, 0]
    cy = pred_centroids[:, 1] * roi_whs[:, 1] + roi_centers[:, 1]
    if z_type == "ABS":
        z = pred_z
    elif z_type == "REL":
        z = pred_z * resize_ratios
    else:
        raise ValueError(f"Unknown z_type: {z_type}")
    tx = z * (cx - roi_cams[:, 0, 2]) / roi_cams[:, 0, 0]
    ty = z * (cy - roi_cams[:, 1, 2]) / roi_cams[:, 1, 1]
    return torch.stack([tx, ty, z], dim=1)


def pose_from_centroid_z(pred_rots: torch.Tensor, pred_centroids: torch.Tensor,
                         pred_z: torch.Tensor, roi_cams: torch.Tensor,
                         roi_centers: torch.Tensor, resize_ratios: torch.Tensor,
                         roi_whs: torch.Tensor, eps: float = 1e-4,
                         is_allo: bool = True, z_type: str = "REL"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """pred_rots [B, 3, 3] or [B, 4] -> (rot_ego [B, 3, 3], t [B, 3])."""
    translation = translation_from_centroid_z(
        pred_centroids, pred_z, roi_cams, roi_centers, resize_ratios, roi_whs, z_type=z_type)
    return _ego_rotation(pred_rots, translation, eps, is_allo), translation


def pose_from_centroid_z_abs(pred_rots: torch.Tensor, pred_centroids: torch.Tensor,
                             pred_z: torch.Tensor, roi_cams: torch.Tensor, eps: float = 1e-4,
                             is_allo: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The variant with absolute centroid pixels [B, 2] and absolute z."""
    pred_z = pred_z.reshape(pred_z.shape[0])
    tx = pred_z * (pred_centroids[:, 0] - roi_cams[:, 0, 2]) / roi_cams[:, 0, 0]
    ty = pred_z * (pred_centroids[:, 1] - roi_cams[:, 1, 2]) / roi_cams[:, 1, 1]
    translation = torch.stack([tx, ty, pred_z], dim=1)
    return _ego_rotation(pred_rots, translation, eps, is_allo), translation


def pose_from_pred(pred_rots: torch.Tensor, pred_transes: torch.Tensor, eps: float = 1e-4,
                   is_allo: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The direct-translation variant: the net's [B, 3] is the translation."""
    return _ego_rotation(pred_rots, pred_transes, eps, is_allo), pred_transes


def centroids_from_poses(trans: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[B, 3] translations through [B, 3, 3] K -> [B, 2] pixel centroids."""
    uvw = (K * trans[:, None, :]).sum(-1)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-8)
