"""GDRN: backbone -> dense geometry -> Patch-PnP -> 6D pose
(counterpart of gdrnet_tpu/models/gdrn.py).

The module takes and returns the JAX package's layouts: `x` is
[B, H, W, 3], `roi_coord_2d` is [B, h, w, 2], and the maps come back NHWC.
Inside it runs NCHW. The rotation and pose decode run in f32 with autocast
off.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gdrnet_tpu_torch.models.conv_pnp_net import ConvPnPNet
from gdrnet_tpu_torch.models.heads import RotWithRegionHead
from gdrnet_tpu_torch.models.resnet import ResNetBackbone, stage_channels
from gdrnet_tpu_torch.ops import pose as pose_ops
from gdrnet_tpu_torch.ops import rotation as R


def rot_param_dim(rot_type: str) -> int:
    if "rot6d" in rot_type:
        return 6
    if "lie_vec" in rot_type:
        return 3
    return 4  # quat / log_quat


def decode_rot(pred_rot: torch.Tensor, rot_type: str) -> torch.Tensor:
    """Net rotation parameters -> [B, 3, 3]."""
    if "rot6d" in rot_type:
        return R.ortho6d_to_mat(pred_rot)
    raise NotImplementedError(
        f"rot type {rot_type!r} is not ported yet (ROADMAP A12; only rot6d is)")


def get_mask_prob(mask_logits: torch.Tensor, mask_loss_type: str) -> torch.Tensor:
    """[B,C,H,W] head mask channels -> [B,1,H,W] probability."""
    if mask_loss_type == "L1":
        flat = mask_logits.flatten(1)
        mx = flat.amax(dim=-1)[:, None, None, None]
        mn = flat.amin(dim=-1)[:, None, None, None]
        return (mask_logits - mn) / (mx - mn).clamp_min(1e-6)
    if mask_loss_type == "BCE":
        return torch.sigmoid(mask_logits)
    if mask_loss_type == "CE":
        return torch.softmax(mask_logits, dim=1)[:, 1:2]
    raise ValueError(f"unknown mask loss type: {mask_loss_type}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GDRN(nn.Module):
    """Arguments mirror MODEL.CDPN.* (gdrnet_tpu/config/defaults.py);
    `compute_dtype` is PARALLEL.DTYPE, as the JAX module's `dtype`."""

    def __init__(self, backbone_depth: int = 34, xyz_loss_type: str = "L1",
                 xyz_bin: int = 64, mask_loss_type: str = "L1", num_regions: int = 8,
                 head_num_layers: int = 3, head_num_filters: int = 256,
                 head_kernel_size: int = 3, head_out_kernel_size: int = 1,
                 head_norm: str = "BN", head_gn_groups: int = 32, num_classes: int = 1,
                 rot_class_aware: bool = False, mask_class_aware: bool = False,
                 region_class_aware: bool = False, pnp_norm: str = "GN",
                 pnp_gn_groups: int = 32, pnp_featdim: int = 128, pnp_num_layers: int = 3,
                 pnp_drop_prob: float = 0.0, pnp_dropblock_size: int = 5,
                 with_2d_coord: bool = False,
                 region_attention: bool = False, mask_attention: str = "none",
                 rot_type: str = "allo_rot6d", trans_type: str = "centroid_z",
                 z_type: str = "REL", output_res: int = 64,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute dtype: {compute_dtype}")
        self.compute_dtype = compute_dtype  # read by engine.steps (bf16 autocast)
        if "rot6d" not in rot_type:
            raise NotImplementedError(
                f"rot type {rot_type!r} is not ported yet (ROADMAP A12; only rot6d is)")
        if trans_type != "centroid_z":
            raise NotImplementedError(
                f"trans type {trans_type!r} is not ported yet (ROADMAP A12)")
        self.num_classes = num_classes
        self.class_aware = rot_class_aware or mask_class_aware or region_class_aware
        self.mask_loss_type = mask_loss_type
        self.with_2d_coord = with_2d_coord
        self.region_attention = region_attention
        self.mask_attention = mask_attention
        self.rot_type = rot_type
        self.z_type = z_type

        rot_output_dim = 3 * (xyz_bin + 1) if xyz_loss_type in ("CE_coor", "CE") else 3
        mask_output_dim = 2 if mask_loss_type == "CE" else 1
        self.backbone = ResNetBackbone(depth=backbone_depth)
        self.rot_head_net = RotWithRegionHead(
            stage_channels(backbone_depth)[-1], rot_output_dim=rot_output_dim,
            mask_output_dim=mask_output_dim, region_output_dim=num_regions + 1,
            num_layers=head_num_layers, num_filters=head_num_filters,
            kernel_size=head_kernel_size, output_kernel_size=head_out_kernel_size,
            norm=head_norm, num_gn_groups=head_gn_groups, num_classes=num_classes,
            rot_class_aware=rot_class_aware, mask_class_aware=mask_class_aware,
            region_class_aware=region_class_aware)
        nbin = rot_output_dim // 3
        pnp_in = 3 * (nbin - 1 if nbin > 1 else 1) + (2 if with_2d_coord else 0)
        pnp_in += num_regions if region_attention else 0
        pnp_in += 1 if mask_attention == "concat" else 0
        self.pnp_net = ConvPnPNet(
            pnp_in, rot_dim=rot_param_dim(rot_type), featdim=pnp_featdim,
            num_layers=pnp_num_layers, norm=pnp_norm, num_gn_groups=pnp_gn_groups,
            drop_prob=pnp_drop_prob, dropblock_size=pnp_dropblock_size,
            mask_attention_type=mask_attention,
            flat_hw=(output_res // 8) ** 2)

    def forward(self, x: torch.Tensor, roi_classes: torch.Tensor | None = None,
                roi_coord_2d: torch.Tensor | None = None,
                roi_cams: torch.Tensor | None = None,
                roi_centers: torch.Tensor | None = None,
                roi_whs: torch.Tensor | None = None,
                roi_extents: torch.Tensor | None = None,
                resize_ratios: torch.Tensor | None = None,
                dropblock_progress: float = 1.0,
                generator: torch.Generator | None = None) -> dict:
        """x [B, H, W, 3] normalized ROI crops. Returns the decoded pose
        ("rot" [B,3,3], "trans" [B,3]), the NHWC maps and the net outputs.
        In train mode the PnP net's DropBlock (if any) draws from `generator`
        at `dropblock_progress` (train step / nr_steps)."""
        head_out = self.rot_head_net(self.backbone(_nchw(x)))
        mask, coor_x, coor_y, coor_z, region = self.rot_head_net.split_outputs(
            head_out, roi_classes if self.class_aware else None)

        if coor_x.shape[1] > 1:  # bin softmax; the last bin is background
            coor_feat = torch.cat([torch.softmax(c[:, :-1], dim=1)
                                   for c in (coor_x, coor_y, coor_z)], dim=1)
        else:
            coor_feat = torch.cat([coor_x, coor_y, coor_z], dim=1)
        if self.with_2d_coord:
            if roi_coord_2d is None:
                raise ValueError("GDRN: with_2d_coord needs roi_coord_2d")
            coor_feat = torch.cat([coor_feat, _nchw(roi_coord_2d).to(coor_feat.dtype)], dim=1)

        # region softmax without the background channel 0
        region_atten = torch.softmax(region[:, 1:], dim=1) if self.region_attention else None
        mask_atten = (get_mask_prob(mask, self.mask_loss_type)
                      if self.mask_attention != "none" else None)

        pred_rot_param, pred_t_ = self.pnp_net(
            coor_feat, region=region_atten, extents=roi_extents, mask_attention=mask_atten,
            dropblock_progress=dropblock_progress, generator=generator)

        with torch.autocast(x.device.type, enabled=False):
            pred_rot_m = decode_rot(pred_rot_param, self.rot_type)
            pred_ego_rot, pred_trans = pose_ops.pose_from_centroid_z(
                pred_rot_m, pred_t_[:, :2], pred_t_[:, 2], roi_cams, roi_centers,
                resize_ratios, roi_whs, is_allo="allo" in self.rot_type, z_type=self.z_type)
        return {
            "rot": pred_ego_rot,
            "trans": pred_trans,
            "mask": _nhwc(mask),
            "coor_x": _nhwc(coor_x),
            "coor_y": _nhwc(coor_y),
            "coor_z": _nhwc(coor_z),
            "region": _nhwc(region),
            "pred_t_": pred_t_,
            "pred_rot_param": pred_rot_param,
        }


def build_model(cfg, device: torch.device | str = "cuda") -> GDRN:
    """MODEL.CDPN config subtree -> GDRN on `device` (weights left at
    PyTorch's default init: load a state dict or call `init_weights`)."""
    net_cfg = cfg.MODEL.CDPN
    bb, rh, pnp, th = net_cfg.BACKBONE, net_cfg.ROT_HEAD, net_cfg.PNP_NET, net_cfg.TRANS_HEAD
    head_cfg = pnp.get("PNP_HEAD_CFG", {})
    if head_cfg.get("type", "ConvPnPNet") != "ConvPnPNet":
        raise NotImplementedError(
            f"pnp head {head_cfg['type']!r} is not ported yet (ROADMAP A12)")
    if th.ENABLED or pnp.R_ONLY:
        raise NotImplementedError("TransHeadNet is not ported yet (ROADMAP A12)")
    if rh.ROT_CONCAT:
        raise NotImplementedError("ROT_CONCAT is not ported yet (ROADMAP A12)")
    if net_cfg.USE_MTL:
        raise NotImplementedError("MTL weighting is not ported yet (ROADMAP A12)")
    model = GDRN(
        backbone_depth=bb.NUM_LAYERS,
        xyz_loss_type=rh.XYZ_LOSS_TYPE,
        xyz_bin=rh.XYZ_BIN,
        mask_loss_type=rh.MASK_LOSS_TYPE,
        num_regions=rh.NUM_REGIONS,
        head_num_layers=rh.NUM_LAYERS,
        head_num_filters=rh.NUM_FILTERS,
        head_kernel_size=rh.CONV_KERNEL_SIZE,
        head_out_kernel_size=rh.OUT_CONV_KERNEL_SIZE,
        head_norm=rh.NORM,
        head_gn_groups=rh.NUM_GN_GROUPS,
        num_classes=rh.NUM_CLASSES,
        rot_class_aware=rh.ROT_CLASS_AWARE,
        mask_class_aware=rh.MASK_CLASS_AWARE,
        region_class_aware=rh.REGION_CLASS_AWARE,
        pnp_norm=head_cfg.get("norm", "GN"),
        pnp_gn_groups=head_cfg.get("num_gn_groups", 32),
        pnp_featdim=head_cfg.get("featdim", 128),
        pnp_num_layers=head_cfg.get("num_layers", 3),
        pnp_drop_prob=head_cfg.get("drop_prob", 0.0),
        pnp_dropblock_size=head_cfg.get("dropblock_size", 5),
        with_2d_coord=pnp.WITH_2D_COORD,
        region_attention=pnp.REGION_ATTENTION,
        mask_attention=pnp.MASK_ATTENTION,
        rot_type=pnp.ROT_TYPE,
        trans_type=pnp.TRANS_TYPE,
        z_type=pnp.Z_TYPE,
        output_res=bb.OUTPUT_RES,
        compute_dtype=cfg.get_path("PARALLEL.DTYPE", "float32"),
    )
    return model.to(device)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for a model without a checkpoint: He-normal
    convs, 1/sqrt(fan_in) linears, zero biases, identity norms with running
    stats (0, 1). `generator` is a CPU generator; draws are made on the CPU
    and copied to the module's device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel() if not isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[0] * w[0, 0].numel()
                gain = 1.0 if isinstance(m, nn.Linear) else 2.0
                std = (gain / fan_in) ** 0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return model
