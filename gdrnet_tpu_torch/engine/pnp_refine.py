"""TEST.USE_PNP post-processing of one padded ROI bucket (counterpart of
gdrnet_tpu/engine/pnp_refine.py).

One call refines the bucket's net poses from the decoded geometry maps,
either on the maps' device (TEST.DEVICE_PNP: ops/device_pnp.
pnp_from_maps_batch, the whole bucket in one batch) or on the host (the
reference's per-ROI solvePnP / solvePnPRansac loop,
core/gdrn_modeling/gdrn_evaluator.py:187-435, through eval/pnp.py on the
numpy stand-ins of cv2). Shared by the test loop (engine/tester.do_test)
and the serving CLI (tools/predict.py).
"""

from __future__ import annotations

import numpy as np
import torch

from gdrnet_tpu_torch.engine.decode import get_out_coor, get_out_mask
from gdrnet_tpu_torch.eval.pnp import (
    correspondences_from_maps,
    pnp_ransac,
    pnp_refine_from_net,
)
from gdrnet_tpu_torch.ops.device_pnp import pnp_from_maps_batch


def refine_bucket_poses(cfg, models, batch: dict, dev_batch: dict, out: dict,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Decoded model outputs -> refined (rot [B,3,3], trans [B,3]) numpy f32.

    `batch` is the mapper's whole bucket (with the host-only keys valid /
    obj_ids / im_hws), `dev_batch` the tensors fed to the model, `out` the
    model's outputs with the geometry maps (make_predict_step(...,
    with_maps=True)). Padding rows keep their net pose. With TEST.DEVICE_PNP
    the RANSAC draws come from a generator on the maps' device seeded with
    `seed` (the bucket's start), so that every bucket draws its own
    hypotheses."""
    pnp_type = cfg.TEST.PNP_TYPE  # ransac_pnp | net_iter_pnp | net_ransac_pnp
    mask_thr = float(cfg.MODEL.CDPN.ROT_HEAD.MASK_THR_TEST)
    xyz_dec = get_out_coor(
        out["coor_x"], out["coor_y"], out["coor_z"], cfg.MODEL.CDPN.ROT_HEAD.XYZ_BIN,
        decode_type=cfg.TEST.get("CE_DECODE_TYPE", "center"))
    mask_dec = get_out_mask(out["mask"], cfg.MODEL.CDPN.ROT_HEAD.MASK_LOSS_TYPE)

    if bool(cfg.TEST.get("DEVICE_PNP")):
        device = xyz_dec.device
        im_wh = torch.from_numpy(np.ascontiguousarray(
            np.asarray(batch["im_hws"], np.float32)[:, ::-1])).to(device)
        R, t = pnp_from_maps_batch(
            mask_dec, xyz_dec, dev_batch["roi_coord_2d"], im_wh, dev_batch["roi_extents"],
            dev_batch["roi_cams"], out["rot"], out["trans"],
            torch.from_numpy(np.asarray(batch["valid"], bool)).to(device),
            mode=pnp_type, mask_thr=mask_thr,
            generator=torch.Generator(device=device).manual_seed(int(seed)))
        return R.cpu().numpy(), t.cpu().numpy()

    # writable copies: the host loop refines rows in place
    rot = out["rot"].float().cpu().numpy().copy()
    trans = out["trans"].float().cpu().numpy().copy()
    xyz_dec = xyz_dec.cpu().numpy()
    mask_dec = mask_dec.cpu().numpy()
    for j in np.flatnonzero(np.asarray(batch["valid"])):
        name = models.meta.id2obj[int(batch["obj_ids"][j])]
        im_h, im_w = int(batch["im_hws"][j][0]), int(batch["im_hws"][j][1])
        img_pts, mdl_pts = correspondences_from_maps(
            mask_dec[j], xyz_dec[j], batch["roi_coord_2d"][j],
            im_w, im_h, models.extents[name], mask_thr=mask_thr)
        K = np.asarray(batch["roi_cams"][j])
        if pnp_type == "ransac_pnp":
            pose = pnp_ransac(mdl_pts, img_pts, K, method="epnp", ransac=True)
            if pose is not None:
                rot[j], trans[j] = pose[:, :3], pose[:, 3]
        else:  # net_iter_pnp | net_ransac_pnp
            ptype = "ransac" if "ransac" in pnp_type else "iter"
            rot[j], trans[j] = pnp_refine_from_net(
                rot[j], trans[j], mdl_pts, img_pts, K, pnp_type=ptype)
    return rot, trans
