"""Point-matching (ADD-style) loss on [B, N, 3] point clouds (counterpart of
gdrnet_tpu/losses/pm_loss.py).

Symmetric objects come as identity-padded [B, K, 3, 3] rotation sets with a
[B, K] mask (ops.symmetry.get_closest_rot_batch). The reference multiplies
the mean-reduced point losses by 3 ("3 is for mean reduction on the point
dim"), kept for parity.
"""

from __future__ import annotations

from functools import partial

import torch

from gdrnet_tpu_torch.losses.basic import get_loss_func, smooth_l1_loss
from gdrnet_tpu_torch.ops import rotation as R
from gdrnet_tpu_torch.ops.pose import transform_pts
from gdrnet_tpu_torch.ops.symmetry import get_closest_rot_batch


def point_matching_loss(
    pred_rots: torch.Tensor,
    gt_rots: torch.Tensor,
    points: torch.Tensor,
    pred_transes: torch.Tensor | None = None,
    gt_transes: torch.Tensor | None = None,
    extents: torch.Tensor | None = None,
    sym_rots: torch.Tensor | None = None,
    sym_mask: torch.Tensor | None = None,
    *,
    loss_type: str = "L1",
    beta: float = 1.0,
    loss_weight: float = 1.0,
    norm_by_extent: bool = False,
    symmetric: bool = False,
    disentangle_t: bool = False,
    disentangle_z: bool = False,
    t_loss_use_points: bool = False,
    r_only: bool = False,
) -> dict[str, torch.Tensor]:
    """pred_rots [B,3,3]; gt_rots [B,3,3] or quaternions [B,4]; points
    [B,N,3]; sym_rots [B,K,3,3] identity-padded with sym_mask [B,K] when
    symmetric."""
    if loss_type.upper() == "SMOOTH_L1":
        loss_func = partial(smooth_l1_loss, beta=beta, reduction="mean")
    else:
        loss_func = partial(get_loss_func(loss_type), reduction="mean")

    if gt_rots.shape[-1] == 4:
        gt_rots = R.quat_to_mat(gt_rots)
    if symmetric:
        if sym_rots is None:
            raise ValueError("point_matching_loss: symmetric needs sym_rots")
        gt_rots = get_closest_rot_batch(pred_rots, gt_rots, sym_rots, sym_mask)

    points_est = transform_pts(points, pred_rots)
    points_tgt = transform_pts(points, gt_rots)

    if norm_by_extent:
        if extents is None:
            raise ValueError("point_matching_loss: norm_by_extent needs extents")
        weights = (1.0 / extents.amax(dim=1, keepdim=True))[:, :, None]  # [B,1,1]
    else:
        weights = 1.0

    if disentangle_z and not disentangle_t:
        disentangle_t = True
    if not disentangle_t and not disentangle_z:
        t_loss_use_points = True

    if r_only:
        return {"loss_PM_R": 3.0 * loss_func(weights * points_est, weights * points_tgt)
                * loss_weight}

    if pred_transes is None or gt_transes is None:
        raise ValueError("point_matching_loss: translations are needed unless r_only")

    def pm(est, tgt):
        return 3.0 * loss_func(weights * est, weights * tgt) * loss_weight

    if disentangle_z:  # R / xy / z
        if t_loss_use_points:
            tgt_RT = points_tgt + gt_transes[:, None, :]
            est_R = points_est + gt_transes[:, None, :]
            t_xy = torch.cat([pred_transes[:, :2], gt_transes[:, 2:]], dim=1)
            t_z = torch.cat([gt_transes[:, :2], pred_transes[:, 2:]], dim=1)
            return {
                "loss_PM_R": pm(est_R, tgt_RT),
                "loss_PM_xy": pm(points_tgt + t_xy[:, None, :], tgt_RT),
                "loss_PM_z": pm(points_tgt + t_z[:, None, :], tgt_RT),
            }
        return {
            "loss_PM_R": pm(points_est, points_tgt),
            "loss_PM_xy_noP": loss_func(pred_transes[:, :2], gt_transes[:, :2]),
            "loss_PM_z_noP": loss_func(pred_transes[:, 2], gt_transes[:, 2]),
        }
    if disentangle_t:  # R / t
        if t_loss_use_points:
            tgt_RT = points_tgt + gt_transes[:, None, :]
            return {
                "loss_PM_R": pm(points_est + gt_transes[:, None, :], tgt_RT),
                "loss_PM_T": pm(points_tgt + pred_transes[:, None, :], tgt_RT),
            }
        return {
            "loss_PM_R": pm(points_est, points_tgt),
            "loss_PM_T_noP": loss_func(pred_transes, gt_transes),
        }
    # fully entangled
    return {"loss_PM_RT": pm(points_est + pred_transes[:, None, :],
                             points_tgt + gt_transes[:, None, :])}
