"""SITE pose decode on tensors (counterpart of gdrnet_tpu/ops/pose.py)."""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.ops import rotation as R


def transform_pts(pts: torch.Tensor, rot: torch.Tensor,
                  t: torch.Tensor | None = None) -> torch.Tensor:
    """Apply [..., 3, 3] rotations (and [..., 3] translations) to [..., N, 3]
    points, in full f32 (broadcast multiply-and-sum, as ops.rotation.mm3)."""
    out = (pts[..., :, None, :] * rot[..., None, :, :]).sum(-1)
    return out if t is None else out + t[..., None, :]


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
    """pred_rots [B, 3, 3] -> (rot_ego [B, 3, 3], t [B, 3])."""
    if pred_rots.dim() == 2 and pred_rots.shape[-1] == 4:
        raise NotImplementedError(
            "quaternion pose decode is not ported yet (ROADMAP A12, quat rot types)")
    if pred_rots.dim() != 3 or pred_rots.shape[-2:] != (3, 3):
        raise ValueError(f"Bad pred_rots shape {tuple(pred_rots.shape)}")
    translation = translation_from_centroid_z(
        pred_centroids, pred_z, roi_cams, roi_centers, resize_ratios, roi_whs, z_type=z_type)
    rot_ego = R.allo_to_ego_mat(translation, pred_rots, eps=eps) if is_allo else pred_rots
    return rot_ego, translation
