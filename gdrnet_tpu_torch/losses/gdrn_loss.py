"""The GDR-Net loss over (model outputs, GT batch) (counterpart of
gdrnet_tpu/losses/gdrn_loss.py).

Gating and weights come from the MODEL.CDPN config subtree. Maps are
channels-last, as GDRN.forward returns them. Call it in f32 (autocast off).
"""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.losses.basic import (
    angular_distance_loss,
    cross_entropy_heatmap_loss,
    l1_loss,
    l2_loss,
    mse_loss,
    rot_l2_loss,
)
from gdrnet_tpu_torch.losses.pm_loss import point_matching_loss

_SIMPLE = {"L1": l1_loss, "L2": l2_loss, "MSE": mse_loss}


def gdrn_loss(cfg, out: dict, batch: dict) -> dict[str, torch.Tensor]:
    """cfg: full config; out: GDRN.forward's dict; batch (channels-last):
    gt_xyz [B,H,W,3], gt_xyz_bin [B,H,W,3] int, gt_mask_{trunc,visib,obj}
    [B,H,W], gt_region [B,H,W] int, gt_ego_rot [B,3,3], gt_trans [B,3],
    gt_trans_ratio [B,3], gt_points [B,N,3], sym_rots [B,K,3,3] with sym_mask
    [B,K], roi_extents [B,3]."""
    net_cfg = cfg.MODEL.CDPN
    rh, pnp = net_cfg.ROT_HEAD, net_cfg.PNP_NET
    if net_cfg.USE_MTL:
        raise NotImplementedError(
            "MTL loss weighting needs the log_vars of a GDRN variant the port does not "
            "have yet (ROADMAP A12)")
    loss_dict: dict[str, torch.Tensor] = {}

    gt_masks = {
        "trunc": batch["gt_mask_trunc"],
        "visib": batch["gt_mask_visib"],
        "obj": batch["gt_mask_obj"],
        "gt": batch["gt_mask_trunc"],  # the reference's MASK_LOSS_GT="gt" is the trunc mask
    }
    out_mask, out_region = out["mask"], out["region"]
    coors = (out["coor_x"], out["coor_y"], out["coor_z"])
    out_rot, out_trans, pred_t_ = out["rot"], out["trans"], out["pred_t_"]

    if not rh.FREEZE:
        # xyz loss, masked and normalised by the mask's pixel count
        gt_mask_xyz = gt_masks[rh.XYZ_LOSS_MASK_GT]  # [B,H,W]
        denom = gt_mask_xyz.sum().clamp_min(1.0)
        m = gt_mask_xyz[..., None]
        names = ("loss_coor_x", "loss_coor_y", "loss_coor_z")
        if rh.XYZ_LOSS_TYPE == "L1":
            gt_xyz = batch["gt_xyz"]
            for i, (name, coor) in enumerate(zip(names, coors)):
                loss_dict[name] = (coor * m - gt_xyz[..., i:i + 1] * m).abs().sum() / denom
        elif rh.XYZ_LOSS_TYPE == "CE_coor":
            gt_bin = batch["gt_xyz_bin"].long()
            mi = gt_mask_xyz.long()
            # the reference multiplies logits AND targets by the mask
            for i, (name, coor) in enumerate(zip(names, coors)):
                loss_dict[name] = cross_entropy_heatmap_loss(
                    coor * m, gt_bin[..., i] * mi, reduction="sum") / denom
        else:
            raise NotImplementedError(f"unknown xyz loss type: {rh.XYZ_LOSS_TYPE}")
        for name in names:
            loss_dict[name] = loss_dict[name] * rh.XYZ_LW

        gt_mask = gt_masks[rh.MASK_LOSS_GT]
        if rh.MASK_LOSS_TYPE == "L1":
            loss_dict["loss_mask"] = l1_loss(out_mask[..., 0], gt_mask)
        elif rh.MASK_LOSS_TYPE == "BCE":
            z = out_mask[..., 0]
            bce = z.clamp_min(0) - z * gt_mask + torch.log1p(torch.exp(-z.abs()))
            loss_dict["loss_mask"] = bce.mean()
        elif rh.MASK_LOSS_TYPE == "CE":
            loss_dict["loss_mask"] = cross_entropy_heatmap_loss(
                out_mask, gt_mask.long(), reduction="mean")
        else:
            raise NotImplementedError(f"unknown mask loss type: {rh.MASK_LOSS_TYPE}")
        loss_dict["loss_mask"] = loss_dict["loss_mask"] * rh.MASK_LW

        # Region CE. The reference's floor is expected, not a training fault:
        # background pixels keep their mask-zeroed (uniform) logits in the sum
        # while only visible pixels count in the denominator, so loss_region
        # converges to about ln(R+1) * total_px / visib_px, not to 0 (about 16
        # for 64 regions at 25 % visibility).
        gt_mask_region = gt_masks[rh.REGION_LOSS_MASK_GT]
        if rh.REGION_LOSS_TYPE != "CE":
            raise NotImplementedError(f"unknown region loss type: {rh.REGION_LOSS_TYPE}")
        denom_r = gt_mask_region.sum().clamp_min(1.0)
        loss_dict["loss_region"] = cross_entropy_heatmap_loss(
            out_region * gt_mask_region[..., None],
            batch["gt_region"].long() * gt_mask_region.long(), reduction="sum") / denom_r
        loss_dict["loss_region"] = loss_dict["loss_region"] * rh.REGION_LW

    if pnp.PM_LW > 0:
        loss_dict.update(point_matching_loss(
            out_rot, batch["gt_ego_rot"], batch["gt_points"],
            pred_transes=out_trans, gt_transes=batch["gt_trans"],
            extents=batch.get("roi_extents"),
            sym_rots=batch.get("sym_rots"), sym_mask=batch.get("sym_mask"),
            loss_type=pnp.PM_LOSS_TYPE, beta=pnp.PM_SMOOTH_L1_BETA,
            loss_weight=pnp.PM_LW, norm_by_extent=pnp.PM_NORM_BY_EXTENT,
            symmetric=pnp.PM_LOSS_SYM, disentangle_t=pnp.PM_DISENTANGLE_T,
            disentangle_z=pnp.PM_DISENTANGLE_Z,
            t_loss_use_points=pnp.PM_T_USE_POINTS, r_only=pnp.PM_R_ONLY))

    if pnp.ROT_LW > 0:
        if pnp.ROT_LOSS_TYPE == "angular":
            loss_dict["loss_rot"] = angular_distance_loss(out_rot, batch["gt_ego_rot"])
        elif pnp.ROT_LOSS_TYPE == "L2":
            loss_dict["loss_rot"] = rot_l2_loss(out_rot, batch["gt_ego_rot"])
        else:
            raise ValueError(f"Unknown rot loss type: {pnp.ROT_LOSS_TYPE}")
        loss_dict["loss_rot"] = loss_dict["loss_rot"] * pnp.ROT_LW

    if pnp.CENTROID_LW > 0:
        if pnp.TRANS_TYPE != "centroid_z":
            raise ValueError("the centroid loss needs TRANS_TYPE centroid_z")
        fn = _SIMPLE[pnp.CENTROID_LOSS_TYPE]
        loss_dict["loss_centroid"] = fn(pred_t_[:, :2], batch["gt_trans_ratio"][:, :2]) \
            * pnp.CENTROID_LW

    if pnp.Z_LW > 0:
        gt_z = batch["gt_trans_ratio"][:, 2] if pnp.Z_TYPE == "REL" else batch["gt_trans"][:, 2]
        loss_dict["loss_z"] = _SIMPLE[pnp.Z_LOSS_TYPE](pred_t_[:, 2], gt_z) * pnp.Z_LW

    if pnp.TRANS_LW > 0:
        fn = _SIMPLE[pnp.TRANS_LOSS_TYPE]
        if pnp.TRANS_LOSS_DISENTANGLE:
            loss_dict["loss_trans_xy"] = fn(out_trans[:, :2], batch["gt_trans"][:, :2]) \
                * pnp.TRANS_LW
            loss_dict["loss_trans_z"] = fn(out_trans[:, 2], batch["gt_trans"][:, 2]) \
                * pnp.TRANS_LW
        else:
            loss_dict["loss_trans_LPnP"] = fn(out_trans, batch["gt_trans"]) * pnp.TRANS_LW

    if pnp.get("BIND_LW", 0.0) > 0.0:  # R^T t
        pred_bind = (out_rot * out_trans[:, :, None]).sum(1)
        gt_bind = (batch["gt_ego_rot"] * batch["gt_trans"][:, :, None]).sum(1)
        loss_dict["loss_bind"] = _SIMPLE[pnp.BIND_LOSS_TYPE](pred_bind, gt_bind) * pnp.BIND_LW

    return loss_dict
