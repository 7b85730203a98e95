"""The mapper's tail on the device (counterpart of
gdrnet_tpu/data/device_pipeline.py), for INPUT.DEVICE_PREPROCESS.

The reference maps each instance on CPU workers (cv2 warps and augs,
data_loader.py:304-633). Here the host only decodes, replaces backgrounds and
stacks the raw full frames (data/mapper.GDRNRawTrainMapper), and this module
makes the ROI train batch from them on the card:

  DZI bbox aug  ->  batched crops (ops/warp: bilinear f32 image, nearest
  masks and xyz)  ->  xyz normalised, CE bins  ->  region labels (nearest FPS
  anchor)  ->  SITE ratios

with the optional colour jitter in front (data/device_augment.py). Its
random draws are a draw half (dzi_draw) taking a key as device_augment's
TorchKey, so JAX's own draws reproduce JAX's batch.
"""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.data.device_augment import apply_color_aug_batch, color_aug_op
from gdrnet_tpu_torch.ops.warp import affine_params_batch, warp_affine_batch, xyz_to_region


def dzi_draw(key, b: int, dzi_type: str = "uniform") -> dict:
    """The draws of dzi_aug_bbox_batch for b boxes."""
    t = dzi_type.lower()
    if t == "uniform":
        ks, kx, ky = key.split(3)
        return {"s": ks.uniform((b,)), "x": kx.uniform((b,)), "y": ky.uniform((b,))}
    if t == "roi10d":
        return {"j": key.uniform((b, 4), -0.15, 0.15)}
    if t == "truncnorm":
        raise NotImplementedError(
            "DZI truncnorm not implemented (the reference raises too, "
            "base_data_loader.py:146-147)")
    if t == "none":
        return {}
    raise ValueError(f"unknown DZI_TYPE for device preprocess: {dzi_type}")


def dzi_apply(draws: dict, bbox_xyxy: torch.Tensor, im_h: int, im_w: int,
              dzi_type: str = "uniform", pad_scale: float = 1.5, scale_ratio: float = 0.25,
              shift_ratio: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched DZI (reference base_data_loader.aug_bbox:120-152, uniform,
    roi10d and none): bbox_xyxy [B, 4] -> (centers [B, 2], scales [B])."""
    x1, y1, x2, y2 = (bbox_xyxy[:, i] for i in range(4))
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    t = dzi_type.lower()
    if t == "uniform":
        s = 1 + scale_ratio * (2 * draws["s"] - 1)
        shx = shift_ratio * (2 * draws["x"] - 1)
        shy = shift_ratio * (2 * draws["y"] - 1)
        centers = torch.stack([cx + bw * shx, cy + bh * shy], dim=1)
        scales = torch.maximum(bh, bw) * s * pad_scale
    elif t == "roi10d":
        # independent +-15 % of each box edge, clipped to the image
        j = draws["j"]
        nx1 = torch.clamp(x1 + bw * j[:, 0], 0, im_w)
        nx2 = torch.clamp(x2 + bw * j[:, 1], 0, im_w)
        ny1 = torch.clamp(y1 + bh * j[:, 2], 0, im_h)
        ny2 = torch.clamp(y2 + bh * j[:, 3], 0, im_h)
        centers = torch.stack([0.5 * (nx1 + nx2), 0.5 * (ny1 + ny2)], dim=1)
        scales = torch.maximum(ny2 - ny1, nx2 - nx1) * pad_scale
    else:
        centers = torch.stack([cx, cy], dim=1)
        scales = torch.maximum(bh, bw) * pad_scale
    scales = torch.clamp(scales, max=float(max(im_h, im_w)))
    return centers, scales


def dzi_aug_bbox_batch(key, bbox_xyxy: torch.Tensor, im_h: int, im_w: int,
                       dzi_type: str = "uniform", pad_scale: float = 1.5,
                       scale_ratio: float = 0.25, shift_ratio: float = 0.25):
    return dzi_apply(dzi_draw(key, bbox_xyxy.shape[0], dzi_type), bbox_xyxy, im_h, im_w,
                     dzi_type, pad_scale, scale_ratio, shift_ratio)


def device_roi_pipeline(key, images, xyz, mask_visib, bboxes_xyxy, rots, trans, K, extents,
                        fps_points, pixel_mean, pixel_std, *, input_res: int = 256,
                        out_res: int = 64, xyz_bin: int = 64, with_bins: bool = False,
                        dzi_type: str = "uniform", pad_scale: float = 1.5,
                        scale_ratio: float = 0.25, shift_ratio: float = 0.25,
                        xyz_mask_gt: str = "visib", mask_trunc=None) -> dict:
    """Raw full frames -> the ROI train batch. images [B, H, W, 3] (bg
    already applied), xyz [B, H, W, 3] object-frame coordinates (0 = bg),
    mask_visib and mask_trunc (defaults to visib) [B, H, W], bboxes_xyxy
    [B, 4], rots [B, 3, 3], trans [B, 3], K [B, 3, 3], extents [B, 3],
    fps_points [B, F, 3], pixel_mean / pixel_std [3]."""
    B, H, W, _ = images.shape
    centers, scales = dzi_aug_bbox_batch(key, bboxes_xyxy, H, W, dzi_type, pad_scale,
                                         scale_ratio, shift_ratio)

    mask_obj = (xyz != 0).any(dim=-1).float()
    mask_visib = mask_visib.float() * mask_obj
    # trunc differs from visib only after the host's bg TRUNCATE_FG
    # (base_data_loader.py:320-364)
    mask_trunc = mask_visib if mask_trunc is None else mask_trunc.float() * mask_obj

    M_in = affine_params_batch(centers, scales, input_res, inv=True)
    M_out = affine_params_batch(centers, scales, out_res, inv=True)

    roi_img = warp_affine_batch(images.float(), M_in, (input_res, input_res),
                                interp="bilinear", axis_aligned=True)  # DZI never rotates
    roi_img = (roi_img - pixel_mean) / pixel_std

    def nearest(t):
        return warp_affine_batch(t, M_out, (out_res, out_res), interp="nearest",
                                 axis_aligned=True)
    roi_xyz = nearest(xyz.float())
    roi_mv = nearest(mask_visib[..., None])[..., 0]
    roi_mt = nearest(mask_trunc[..., None])[..., 0]
    roi_mo = nearest(mask_obj[..., None])[..., 0]

    region = xyz_to_region(roi_xyz, fps_points)  # nearest FPS anchor, 0 = bg
    xyz_norm = roi_xyz / extents[:, None, None, :] + 0.5

    # the full image's normalized coordinate map cropped to the ROI
    dev = images.device
    dy = torch.arange(out_res, device=dev, dtype=torch.float32)[:, None]
    dx = torch.arange(out_res, device=dev, dtype=torch.float32)[None, :]
    m = M_out[:, :, :, None, None]
    sx = m[:, 0, 0] * dx + m[:, 0, 1] * dy + m[:, 0, 2]
    sy = m[:, 1, 0] * dx + m[:, 1, 1] * dy + m[:, 1, 2]
    coord2d = torch.stack([sx / max(W - 1, 1), sy / max(H - 1, 1)], dim=-1)

    # SITE ratios (data_loader.py:628-632)
    uvw = K[:, :, 0] * trans[:, None, 0] + K[:, :, 1] * trans[:, None, 1] \
        + K[:, :, 2] * trans[:, None, 2]
    centroid = uvw[:, :2] / torch.clamp(uvw[:, 2:3], min=1e-12)
    bw = torch.clamp(bboxes_xyxy[:, 2] - bboxes_xyxy[:, 0], min=1.0)
    bh = torch.clamp(bboxes_xyxy[:, 3] - bboxes_xyxy[:, 1], min=1.0)
    dc = centroid - centers
    resize_ratio = out_res / scales
    trans_ratio = torch.stack([dc[:, 0] / bw, dc[:, 1] / bh, trans[:, 2] / resize_ratio], dim=1)

    batch = {
        "roi_img": roi_img,
        "roi_coord_2d": coord2d,
        "roi_cams": K,
        "roi_centers": centers,
        "roi_whs": torch.stack([bw, bh], dim=1),
        "roi_extents": extents,
        "resize_ratios": resize_ratio,
        "gt_xyz": xyz_norm,
        "gt_mask_trunc": roi_mt,
        "gt_mask_visib": roi_mv,
        "gt_mask_obj": roi_mo,
        "gt_region": region,
        "gt_ego_rot": rots,
        "gt_trans": trans,
        "gt_trans_ratio": trans_ratio,
    }
    if with_bins:
        bins = (torch.clamp(xyz_norm, 0.0, 0.999999) * xyz_bin).to(torch.int32)
        m = {"trunc": roi_mt, "visib": roi_mv, "obj": roi_mo}[xyz_mask_gt]
        batch["gt_xyz_bin"] = torch.where(m[..., None] == 0,
                                          torch.full((), xyz_bin, dtype=torch.int32, device=dev),
                                          bins)
    else:
        batch["gt_xyz_bin"] = torch.zeros((B, out_res, out_res, 3), dtype=torch.int32,
                                          device=dev)
    return batch


def device_train_batch(key, raw: dict, points_stack, extents_stack, fps_stack, sym_rots_stack,
                       sym_mask_stack, pixel_mean, pixel_std, color_aug_type: str | None = None,
                       color_aug_prob: float = 0.0, color_aug_code: str | None = None,
                       color_aug_channel_order: str = "bgr", color_op=None,
                       **pipeline_kwargs) -> dict:
    """Raw mapper batch (GDRNRawTrainMapper: uint8 image, f16 xyz, uint8
    masks, bbox / pose / K / class, all on the device) -> the full GDRN train
    batch. The per-class constants (PM model points, extents, FPS anchors,
    padded symmetry sets) are gathered from the [C, ...] stacks by class
    index. With a colour type and prob > 0 the jitter runs first, on the
    full frames, gated by each frame's aug_ok flag; `color_op` is
    device_augment.color_aug_op's result when the caller built it once."""
    cls = raw["roi_classes"].long()
    extents = extents_stack[cls]
    images = raw["image"].float()
    if color_aug_type and color_aug_prob > 0.0:
        key, k_aug = key.split(2)
        aug_ok = raw.get("aug_ok")
        if aug_ok is None:
            aug_ok = torch.ones(images.shape[0], dtype=torch.uint8, device=images.device)
        images = apply_color_aug_batch(
            k_aug, images, aug_ok, prob=float(color_aug_prob),
            op=color_op or color_aug_op(color_aug_type, color_aug_code or None,
                                        color_aug_channel_order))
    batch = device_roi_pipeline(
        key, images, raw["xyz"].float(), raw["mask_visib"], raw["bbox"].float(),
        raw["gt_ego_rot"].float(), raw["gt_trans"].float(), raw["roi_cams"].float(), extents,
        fps_stack[cls], pixel_mean, pixel_std, mask_trunc=raw.get("mask_trunc"),
        **pipeline_kwargs)
    batch["roi_classes"] = cls.to(torch.int32)
    batch["gt_points"] = points_stack[cls]
    batch["sym_rots"] = sym_rots_stack[cls]
    batch["sym_mask"] = sym_mask_stack[cls]
    return batch
