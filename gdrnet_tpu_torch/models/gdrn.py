"""GDRN: backbone -> dense geometry -> PnP head -> 6D pose
(counterpart of gdrnet_tpu/models/gdrn.py).

The module takes and returns the JAX package's layouts: `x` is
[B, H, W, 3], `roi_coord_2d` is [B, h, w, 2], and the maps come back NHWC.
Inside it runs NCHW. The rotation and pose decode run in f32 with autocast
off.

Every variant that MODEL.CDPN describes: ResNet-18/34/50/101/152, ROT_CONCAT
(the backbone's skips into the geometry head), the Patch-PnP ConvPnPNet or
the PointNet-like PointPnPNet / SimplePointPnPNet, the rotation as rot6d,
quaternion, log-quaternion or Lie vector (allo- or egocentric), the
translation as SITE (centroid_z, centroid_z_abs) or direct (trans), R_ONLY
with the translation from TransHeadNet, and the MTL log-variances
(log_var_<name>, one a loss term of MTL_LOSS_NAMES, zeros at init).

FREEZE, as the JAX package's: a frozen backbone, geometry head or
TransHeadNet runs its BatchNorms on their running statistics in train mode
too (GDRN.train keeps it in eval mode), and its outputs are detached, so it
gets no gradient and passes none back; a frozen ConvPnPNet only has its
outputs detached (its norms and DropBlock keep the train mode, as in JAX),
and the point heads have no FREEZE in the JAX package, so none here. The
optimizer still sees the frozen parameters with zero gradients, so weight
decay moves them, as optax's does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gdrnet_tpu_torch.models.conv_pnp_net import ConvPnPNet
from gdrnet_tpu_torch.models.heads import RotWithRegionHead, TransHeadNet
from gdrnet_tpu_torch.models.point_pnp_net import PointPnPNet, SimplePointPnPNet
from gdrnet_tpu_torch.models.resnet import ResNetBackbone, stage_channels
from gdrnet_tpu_torch.ops import pose as pose_ops
from gdrnet_tpu_torch.ops import rotation as R

MTL_LOSS_NAMES = (
    "mask", "coor_x", "coor_y", "coor_z", "coor_x_bin", "coor_y_bin",
    "coor_z_bin", "region", "PM_R", "PM_xy", "PM_z", "PM_xy_noP", "PM_z_noP",
    "PM_T", "PM_T_noP", "PM_RT", "centroid", "z", "trans_xy", "trans_z",
    "trans_LPnP", "rot", "bind",
)
PNP_HEADS = ("ConvPnPNet", "PointPnPNet", "SimplePointPnPNet")
TRANS_TYPES = ("centroid_z", "centroid_z_abs", "trans")


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
    if "log_quat" in rot_type:
        return R.quat_to_mat(R.quat_exp(pred_rot))
    if "lie_vec" in rot_type:
        return R.so3_exp(pred_rot)
    if "quat" in rot_type:
        return R.quat_to_mat(pred_rot)
    raise ValueError(f"Unknown rot type: {rot_type}")


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

    def __init__(self, backbone_depth: int = 34, backbone_freeze: bool = False,
                 rot_concat: bool = False, xyz_loss_type: str = "L1",
                 xyz_bin: int = 64, mask_loss_type: str = "L1", num_regions: int = 8,
                 head_num_layers: int = 3, head_num_filters: int = 256,
                 head_kernel_size: int = 3, head_out_kernel_size: int = 1,
                 head_norm: str = "BN", head_gn_groups: int = 32, head_freeze: bool = False,
                 num_classes: int = 1,
                 rot_class_aware: bool = False, mask_class_aware: bool = False,
                 region_class_aware: bool = False, pnp_head_type: str = "ConvPnPNet",
                 pnp_norm: str = "GN",
                 pnp_gn_groups: int = 32, pnp_featdim: int = 128, pnp_num_layers: int = 3,
                 pnp_drop_prob: float = 0.0, pnp_dropblock_size: int = 5,
                 pnp_freeze: bool = False, with_2d_coord: bool = False,
                 region_attention: bool = False, mask_attention: str = "none",
                 rot_type: str = "allo_rot6d", trans_type: str = "centroid_z",
                 z_type: str = "REL", r_only: bool = False, trans_head_freeze: bool = True,
                 use_mtl: bool = False, output_res: int = 64,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute dtype: {compute_dtype}")
        self.compute_dtype = compute_dtype  # read by engine.steps (bf16 autocast)
        if trans_type not in TRANS_TYPES:
            raise ValueError(f"Unknown trans type: {trans_type}")
        if pnp_head_type not in PNP_HEADS:
            raise ValueError(f"Unknown pnp head type: {pnp_head_type}")
        if not any(k in rot_type for k in ("rot6d", "quat", "lie_vec")):
            raise ValueError(f"Unknown rot type: {rot_type}")
        self.num_classes = num_classes
        self.class_aware = rot_class_aware or mask_class_aware or region_class_aware
        self.mask_loss_type = mask_loss_type
        self.with_2d_coord = with_2d_coord
        self.region_attention = region_attention
        self.mask_attention = mask_attention
        self.rot_type = rot_type
        self.trans_type = trans_type
        self.z_type = z_type
        self.rot_concat = rot_concat
        self.r_only = r_only
        self.freeze = {"backbone": backbone_freeze, "rot_head_net": head_freeze,
                       "pnp_net": pnp_freeze and pnp_head_type == "ConvPnPNet",
                       "trans_head_net": r_only and trans_head_freeze}

        rot_output_dim = 3 * (xyz_bin + 1) if xyz_loss_type in ("CE_coor", "CE") else 3
        mask_output_dim = 2 if mask_loss_type == "CE" else 1
        channels = stage_channels(backbone_depth)
        self.backbone = ResNetBackbone(depth=backbone_depth, rot_concat=rot_concat)
        self.rot_head_net = RotWithRegionHead(
            channels[-1], rot_output_dim=rot_output_dim,
            mask_output_dim=mask_output_dim, region_output_dim=num_regions + 1,
            num_layers=head_num_layers, num_filters=head_num_filters,
            kernel_size=head_kernel_size, output_kernel_size=head_out_kernel_size,
            norm=head_norm, num_gn_groups=head_gn_groups, num_classes=num_classes,
            rot_class_aware=rot_class_aware, mask_class_aware=mask_class_aware,
            region_class_aware=region_class_aware,
            concat_channels=channels[2::-1] if rot_concat else ())
        nbin = rot_output_dim // 3
        coor_in = 3 * (nbin - 1 if nbin > 1 else 1) + (2 if with_2d_coord else 0)
        pnp_in = coor_in + (num_regions if region_attention else 0)
        pnp_in += 1 if mask_attention == "concat" else 0
        rot_dim = rot_param_dim(rot_type)
        if pnp_head_type == "PointPnPNet":
            self.pnp_net = PointPnPNet(coor_in, rot_dim=rot_dim, num_regions=num_regions)
        elif pnp_head_type == "SimplePointPnPNet":
            self.pnp_net = SimplePointPnPNet(pnp_in, rot_dim=rot_dim,
                                             mask_attention_type=mask_attention)
        else:
            map_res = output_res * (2 if rot_concat else 1)  # concat maps are 2x (heads.py)
            self.pnp_net = ConvPnPNet(
                pnp_in, rot_dim=rot_dim, featdim=pnp_featdim,
                num_layers=pnp_num_layers, norm=pnp_norm, num_gn_groups=pnp_gn_groups,
                drop_prob=pnp_drop_prob, dropblock_size=pnp_dropblock_size,
                mask_attention_type=mask_attention,
                flat_hw=(map_res // 8) ** 2)
        # the JAX package makes TransHeadNet's parameters only where it calls it: R_ONLY
        self.trans_head_net = (TransHeadNet(channels[-1], flat_hw=(output_res // 8) ** 2)
                               if r_only else None)
        self.use_mtl = use_mtl
        for name in MTL_LOSS_NAMES if use_mtl else ():
            setattr(self, f"log_var_{name}", nn.Parameter(torch.zeros(1)))

    def train(self, mode: bool = True) -> "GDRN":
        """Train mode, but a frozen backbone, geometry head or TransHeadNet
        stays in eval mode (its BatchNorms read their running statistics)."""
        super().train(mode)
        for name in ("backbone", "rot_head_net", "trans_head_net"):
            if self.freeze[name]:
                getattr(self, name).train(False)
        return self

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
        feats = self.backbone(_nchw(x))
        if self.freeze["backbone"]:
            feats = tuple(f.detach() for f in feats) if self.rot_concat else feats.detach()
        if self.rot_concat:
            feat, f64, f32, f16 = feats
            head_out = self.rot_head_net(feat, (f16, f32, f64))
        else:
            feat = feats
            head_out = self.rot_head_net(feat)
        if self.freeze["rot_head_net"]:
            head_out = head_out.detach()
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
            if tuple(roi_coord_2d.shape[1:3]) != tuple(coor_feat.shape[2:]):
                raise ValueError(
                    f"GDRN: the head's maps are {tuple(coor_feat.shape[2:])} and roi_coord_2d "
                    f"is {tuple(roi_coord_2d.shape[1:3])}: ROT_CONCAT doubles the maps, so it "
                    "cannot take WITH_2D_COORD (the JAX package fails the same concatenation)")
            coor_feat = torch.cat([coor_feat, _nchw(roi_coord_2d).to(coor_feat.dtype)], dim=1)

        # region softmax without the background channel 0
        region_atten = torch.softmax(region[:, 1:], dim=1) if self.region_attention else None
        mask_atten = (get_mask_prob(mask, self.mask_loss_type)
                      if self.mask_attention != "none" else None)

        pred_rot_param, pred_t_ = self.pnp_net(
            coor_feat, region=region_atten, extents=roi_extents, mask_attention=mask_atten,
            dropblock_progress=dropblock_progress, generator=generator)
        if self.freeze["pnp_net"]:
            pred_rot_param, pred_t_ = pred_rot_param.detach(), pred_t_.detach()
        if self.r_only:
            pred_t_ = self.trans_head_net(feat)
            if self.freeze["trans_head_net"]:
                pred_t_ = pred_t_.detach()

        with torch.autocast(x.device.type, enabled=False):
            pred_rot_m = decode_rot(pred_rot_param, self.rot_type)
            is_allo = "allo" in self.rot_type
            if self.trans_type == "centroid_z":
                pred_ego_rot, pred_trans = pose_ops.pose_from_centroid_z(
                    pred_rot_m, pred_t_[:, :2], pred_t_[:, 2], roi_cams, roi_centers,
                    resize_ratios, roi_whs, is_allo=is_allo, z_type=self.z_type)
            elif self.trans_type == "centroid_z_abs":
                pred_ego_rot, pred_trans = pose_ops.pose_from_centroid_z_abs(
                    pred_rot_m, pred_t_[:, :2], pred_t_[:, 2], roi_cams, is_allo=is_allo)
            else:
                pred_ego_rot, pred_trans = pose_ops.pose_from_pred(pred_rot_m, pred_t_,
                                                                   is_allo=is_allo)
        out = {
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
        if self.use_mtl:
            out["log_vars"] = {n: getattr(self, f"log_var_{n}") for n in MTL_LOSS_NAMES}
        return out


# the std of a standard normal truncated at +-2 (flax's variance_scaling
# divides by it, so that the truncated draw keeps the variance asked for)
_TRUNC_NORMAL_STD = 0.87962566103423978


def build_model(cfg, device: torch.device | str = "cuda") -> GDRN:
    """MODEL.CDPN config subtree -> GDRN on `device` (weights left at
    PyTorch's default init: load a state dict or call `init_weights`)."""
    net_cfg = cfg.MODEL.CDPN
    bb, rh, pnp, th = net_cfg.BACKBONE, net_cfg.ROT_HEAD, net_cfg.PNP_NET, net_cfg.TRANS_HEAD
    head_cfg = pnp.get("PNP_HEAD_CFG", {})
    model = GDRN(
        backbone_depth=bb.NUM_LAYERS,
        backbone_freeze=bb.FREEZE,
        rot_concat=rh.ROT_CONCAT,
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
        head_freeze=rh.FREEZE,
        num_classes=rh.NUM_CLASSES,
        rot_class_aware=rh.ROT_CLASS_AWARE,
        mask_class_aware=rh.MASK_CLASS_AWARE,
        region_class_aware=rh.REGION_CLASS_AWARE,
        pnp_head_type=head_cfg.get("type", "ConvPnPNet"),
        pnp_norm=head_cfg.get("norm", "GN"),
        pnp_gn_groups=head_cfg.get("num_gn_groups", 32),
        pnp_featdim=head_cfg.get("featdim", 128),
        pnp_num_layers=head_cfg.get("num_layers", 3),
        pnp_drop_prob=head_cfg.get("drop_prob", 0.0),
        pnp_dropblock_size=head_cfg.get("dropblock_size", 5),
        pnp_freeze=pnp.FREEZE,
        with_2d_coord=pnp.WITH_2D_COORD,
        region_attention=pnp.REGION_ATTENTION,
        mask_attention=pnp.MASK_ATTENTION,
        rot_type=pnp.ROT_TYPE,
        trans_type=pnp.TRANS_TYPE,
        z_type=pnp.Z_TYPE,
        r_only=pnp.R_ONLY,
        trans_head_freeze=th.FREEZE,
        use_mtl=net_cfg.USE_MTL,
        output_res=bb.OUTPUT_RES,
        compute_dtype=cfg.get_path("PARALLEL.DTYPE", "float32"),
    )
    return model.to(device)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for a model without a checkpoint, by the JAX
    package's per-layer rules (the reference's normal_init of the heads):
    the backbone's convs, Bottlenecks' too, lecun-normal (flax's default: a
    normal of variance 1 / fan_in truncated at 2 std); every conv,
    transposed conv and linear of the geometry head, the PnP head (the point
    MLPs too) and TransHeadNet normal(0, 0.001), but the pose regressors
    fc_r, fc_t and fc_pose normal(0, 0.01)
    (gdrnet_tpu/models/{heads,conv_pnp_net,point_pnp_net,layers}.py); zero
    biases, identity norms with running stats (0, 1), MTL log-variances 0. `generator` is a
    CPU generator; draws are made on the CPU and copied to the module's
    device."""

    def draw(w: torch.Tensor, std: float, truncated: bool = False) -> None:
        v = torch.empty(w.shape)
        if truncated:
            nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
        else:
            v.normal_(generator=generator)
        w.copy_(v * std)

    with torch.no_grad():
        for m in model.backbone.modules():
            if isinstance(m, nn.Conv2d):
                draw(m.weight, (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_NORMAL_STD, True)
        regressors = [getattr(model.pnp_net, n) for n in ("fc_r", "fc_t", "fc_pose")
                      if hasattr(model.pnp_net, n)]
        for head in (model.rot_head_net, model.pnp_net, model.trans_head_net):
            for m in head.modules() if head is not None else ():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    draw(m.weight, 0.01 if any(m is r for r in regressors) else 0.001)
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and m.bias is not None:
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        for name, p in model.named_parameters():
            if name.startswith("log_var_"):
                p.zero_()
    return model
