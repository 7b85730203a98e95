"""The closed-form ROI affine (a copy of gdrnet_tpu/ops/warp.py:affine_params,
which cannot be imported without JAX).

Its f32 result is what the mapper's warps see: data/cv_ops.warp_affine
inverts it in f64 as cv2.warpAffine does, so the rounding to f32 here is part
of the crop.
"""

from __future__ import annotations

import math

import numpy as np


def affine_params(center, scale, rot_deg, output_size, shift=(0.0, 0.0), inv=False):
    """2x3 affine mapping the (center, scale)-square to output_size.

    center (cx, cy); scale scalar or (w, h) — only w sets the zoom (the
    reference's src_w, data_utils.py:113); rot in degrees; output_size scalar
    or (w, h). Returns numpy [2, 3] f32 equal to the reference's
    cv2.getAffineTransform result.
    """
    center = np.asarray(center, dtype=np.float64)
    if np.isscalar(scale):
        scale = (float(scale), float(scale))
    scale = np.asarray(scale, dtype=np.float64)
    if np.isscalar(output_size):
        output_size = (int(output_size), int(output_size))
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    theta = math.pi * float(rot_deg) / 180.0
    k = dst_w / scale[0]
    cs, sn = math.cos(theta), math.sin(theta)
    # forward: dst = k * R(-theta) @ (src - center - scale*shift) + (dst_w/2, dst_h/2)
    lin = k * np.array([[cs, sn], [-sn, cs]], dtype=np.float64)
    src0 = center + scale * np.asarray(shift, dtype=np.float64)
    if inv:
        lin_inv = np.linalg.inv(lin)
        t = src0 - lin_inv @ np.array([dst_w * 0.5, dst_h * 0.5])
        return np.concatenate([lin_inv, t[:, None]], axis=1).astype(np.float32)
    t = np.array([dst_w * 0.5, dst_h * 0.5]) - lin @ src0
    return np.concatenate([lin, t[:, None]], axis=1).astype(np.float32)
