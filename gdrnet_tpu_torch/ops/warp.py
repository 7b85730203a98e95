"""ROI affines, batched warps, coordinate maps and region labels
(counterpart of gdrnet_tpu/ops/warp.py).

affine_params is a copy of JAX's closed-form ROI affine; its f32 result is
what the host mapper's warps see: data/cv_ops.warp_affine inverts it in f64
as cv2.warpAffine does, so the rounding to f32 here is part of the crop.
The rest works on torch tensors on any device for the device-side input
path (data/device_pipeline.py, data/device_pool.py and the device test
mapper): the same arithmetic as JAX's jnp functions, in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# batched warps on tensors (counterpart of gdrnet_tpu/ops/warp.py:60-231)
#
# Tensors on any device, f32 arithmetic written out elementwise (no matmul, so
# TF32 cannot enter): the same values JAX computes at precision="highest".
# Conventions of cv2.warpAffine with borderValue=0: dst pixel (x, y) samples
# the source at M_inv @ (x, y, 1), integer coordinates are pixel positions,
# out-of-bounds taps contribute 0.
# ---------------------------------------------------------------------------


def affine_params_batch(centers: torch.Tensor, scales: torch.Tensor, output_size: int,
                        rot_deg: torch.Tensor | None = None, inv: bool = False) -> torch.Tensor:
    """centers [B, 2], scales [B] (square ROIs), optional rot [B] degrees ->
    [B, 2, 3] forward (or inverse) affines."""
    B = centers.shape[0]
    scales = scales.reshape(B)
    theta = (torch.zeros(B, dtype=centers.dtype, device=centers.device) if rot_deg is None
             else rot_deg * (math.pi / 180.0))
    k = output_size / scales
    cs, sn = torch.cos(theta), torch.sin(theta)
    if inv:
        # src = (1/k) R(theta) (dst - dst0) + center; x / k as x * scale / size,
        # the form XLA's simplifier gives JAX's jitted x / (size / scale)
        r00, r01 = cs * scales / output_size, -sn * scales / output_size
        r10, r11 = sn * scales / output_size, cs * scales / output_size
        d0 = output_size * 0.5
        t0 = centers[:, 0] - (r00 * d0 + r01 * d0)
        t1 = centers[:, 1] - (r10 * d0 + r11 * d0)
    else:
        r00, r01 = k * cs, k * sn
        r10, r11 = -k * sn, k * cs
        t0 = output_size * 0.5 - (r00 * centers[:, 0] + r01 * centers[:, 1])
        t1 = output_size * 0.5 - (r10 * centers[:, 0] + r11 * centers[:, 1])
    row0 = torch.stack([r00, r01, t0], dim=-1)
    row1 = torch.stack([r10, r11, t1], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_apply(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Apply [..., 2, 3] affines to [..., N, 2] points
    (ref affine_transform, data_utils.py:141)."""
    return (M[..., None, :, 0] * pts[..., :, 0:1] + M[..., None, :, 1] * pts[..., :, 1:2]
            + M[..., None, :, 2])


def _source_coords(M_inv: torch.Tensor, oh: int, ow: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, oh, ow] source x and y of every output pixel."""
    dev = M_inv.device
    dy = torch.arange(oh, device=dev, dtype=torch.float32)[:, None]
    dx = torch.arange(ow, device=dev, dtype=torch.float32)[None, :]
    m = M_inv[:, :, :, None, None]
    sx = m[:, 0, 0] * dx + m[:, 0, 1] * dy + m[:, 0, 2]
    sy = m[:, 1, 0] * dx + m[:, 1, 1] * dy + m[:, 1, 2]
    return sx, sy


def _gather_hw(flat: torch.Tensor, H: int, W: int, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """flat [B or 1, H*W, C], integer xs / ys [B, h, w] -> [B, h, w, C], 0 outside."""
    B, h, w = xs.shape
    C = flat.shape[-1]
    inb = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(B, h * w, 1)
    src = flat.expand(B, -1, -1)
    vals = torch.gather(src, 1, idx.expand(B, h * w, C)).reshape(B, h, w, C)
    return torch.where(inb[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def _warp_gather(imgs: torch.Tensor, M_inv: torch.Tensor, out_hw: tuple[int, int],
                 interp: str) -> torch.Tensor:
    """The general affine warp (JAX's _warp_one): imgs [B or 1, H, W, C]."""
    oh, ow = out_hw
    H, W, C = imgs.shape[1], imgs.shape[2], imgs.shape[3]
    flat = imgs.reshape(imgs.shape[0], H * W, C)
    sx, sy = _source_coords(M_inv, oh, ow)
    if interp == "nearest":
        return _gather_hw(flat, H, W, torch.round(sx).long(), torch.round(sy).long())
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = flat.float()
    v00 = _gather_hw(flat, H, W, x0i, y0i)
    v01 = _gather_hw(flat, H, W, x0i + 1, y0i)
    v10 = _gather_hw(flat, H, W, x0i, y0i + 1)
    v11 = _gather_hw(flat, H, W, x0i + 1, y0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _axis_taps(scale: torch.Tensor, offset: torch.Tensor, out_n: int, src_n: int,
               interp: str) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """The taps of s = scale * o + offset along one axis, [B, out_n] each:
    (clamped source index, weight with 0 for a tap out of range; None for
    nearest's one exact tap, whose out-of-range mask is the weight's job)."""
    # one rounding of scale * o + offset, as the fused multiply-add that XLA
    # compiles JAX's expression to (an f32 product is exact in f64)
    o = torch.arange(out_n, device=scale.device, dtype=torch.float64)
    s = (scale.double()[:, None] * o[None, :] + offset.double()[:, None]).float()
    if interp == "nearest":
        i = torch.round(s).long()
        return [(i.clamp(0, src_n - 1), ((i >= 0) & (i < src_n)).float())]
    lo = torch.floor(s)
    w = s - lo
    lo_i = lo.long()
    taps = []
    for i, wt in ((lo_i, 1.0 - w), (lo_i + 1, w)):
        valid = (i >= 0) & (i < src_n)
        taps.append((i.clamp(0, src_n - 1), torch.where(valid, wt, torch.zeros_like(wt))))
    return taps


def _warp_separable(imgs: torch.Tensor, M_inv: torch.Tensor, out_hw: tuple[int, int],
                    interp: str) -> torch.Tensor:
    """Axis-aligned warp (JAX's _warp_separable_batch): rows, then columns.
    JAX multiplies by dense one-hot interpolation matrices (two nonzero
    weights a row for bilinear, one for nearest) for the TPU's matrix unit;
    here the same weights gather their two taps (one) directly, which
    computes the same sums without the zero terms."""
    oh, ow = out_hw
    B, H, W, C = imgs.shape
    x = imgs.float()
    rows = None
    for idx, wt in _axis_taps(M_inv[:, 1, 1], M_inv[:, 1, 2], oh, H, interp):
        g = torch.gather(x, 1, idx[:, :, None, None].expand(B, oh, W, C)) * wt[:, :, None, None]
        rows = g if rows is None else rows + g
    out = None
    for idx, wt in _axis_taps(M_inv[:, 0, 0], M_inv[:, 0, 2], ow, W, interp):
        g = torch.gather(rows, 2, idx[:, None, :, None].expand(B, oh, ow, C)) * wt[:, None, :, None]
        out = g if out is None else out + g
    return out


def warp_affine_batch(imgs: torch.Tensor, M_inv: torch.Tensor, out_hw: tuple[int, int],
                      interp: str = "bilinear", axis_aligned: bool = False) -> torch.Tensor:
    """Batched inverse-map affine warp: imgs [B, H, W, C], M_inv [B, 2, 3]
    (dst -> src) -> [B, oh, ow, C] (cv2.warpAffine per ROI in the reference,
    data_utils.crop_resize_by_warp_affine:80-93). Bilinear returns f32;
    nearest keeps the dtype on the gather path and is f32 on the
    axis-aligned one, as in JAX. axis_aligned=True asserts M_inv has zero
    off-diagonals (every DZI and test crop) and samples rows and columns
    separately."""
    if axis_aligned:
        return _warp_separable(imgs, M_inv, out_hw, interp)
    return _warp_gather(imgs, M_inv, out_hw, interp)


def crop_resize_batch(imgs: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                      out_size: int, interp: str = "bilinear") -> torch.Tensor:
    """Square ROIs (centers [B, 2], scales [B]) of imgs [B, H, W, C] resized
    to out_size (no rotation: the axis-aligned path)."""
    M_inv = affine_params_batch(centers, scales, out_size, inv=True)
    return warp_affine_batch(imgs, M_inv, (out_size, out_size), interp=interp,
                             axis_aligned=True)


def crop_resize_from_single_image(img: torch.Tensor, centers: torch.Tensor,
                                  scales: torch.Tensor, out_size: int,
                                  interp: str = "bilinear") -> torch.Tensor:
    """All ROIs of one image [H, W, C] -> [B, out, out, C] (the test-time
    layout, data_loader.py:389-451), without replicating the image."""
    M_inv = affine_params_batch(centers, scales, out_size, inv=True)
    return _warp_gather(img[None], M_inv, (out_size, out_size), interp)


# ---------------------------------------------------------------------------
# coordinate maps & region assignment
# ---------------------------------------------------------------------------


def get_2d_coord(width: int, height: int, low: float = 0.0, high: float = 1.0,
                 fmt: str = "HWC", device="cpu") -> torch.Tensor:
    """Normalized pixel-coordinate map (ref get_2d_coord_np,
    data_utils.py:222-241): [H, W, 2] (HWC) or [2, H, W] (CHW), f32."""
    x = torch.linspace(low, high, width, dtype=torch.float32, device=device)
    y = torch.linspace(low, high, height, dtype=torch.float32, device=device)
    ym, xm = torch.meshgrid(y, x, indexing="ij")
    xy = torch.stack([xm, ym], dim=-1)
    return xy if fmt == "HWC" else xy.permute(2, 0, 1)


def xyz_to_region(xyz: torch.Tensor, fps_points: torch.Tensor) -> torch.Tensor:
    """Nearest-FPS-anchor region labels: xyz [..., H, W, 3] object-frame
    coordinates (0 = background), fps_points [..., F, 3] -> int32
    [..., H, W] in {0..F}, 0 = background (ref xyz_to_region,
    data_utils.py:213-220). Ties go to the first anchor, as argmin does."""
    d = xyz[..., None, :] - fps_points[..., None, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    region = torch.argmin(d2, dim=-1).to(torch.int32) + 1
    return torch.where((xyz != 0).any(dim=-1), region, torch.zeros_like(region))


def mask_from_xyz(xyz: torch.Tensor) -> torch.Tensor:
    """Visible-object mask from an XYZ map (nonzero anywhere), f32 (ref
    data_loader.py:468)."""
    return (xyz != 0).any(dim=-1).float()
