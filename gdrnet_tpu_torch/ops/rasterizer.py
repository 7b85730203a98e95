"""Triangle z-buffer renders of meshes (counterpart of
gdrnet_tpu/ops/rasterizer.py: rasterize_attr, render_xyz, render_depth,
window_origin, render_xyz_roi, render_xyz_roi_many, paste_window,
xyz_crop_from_render).

Same design and conventions as the JAX module: an edge-function test of
every (pixel, face) pair with perspective-correct interpolation (attr/z and
1/z linear in screen space); the sample point of pixel (i, j) is (x=j, y=i),
with no half-pixel offset; the nearest face wins and ties go to the lowest
face index; depth 0 means no hit.

Every depth/XYZ render here goes through ops.kernels.rasterize_xyz, which
launches the CUDA kernel for a CUDA `device` and runs its plain version on
the CPU: the windows of render_xyz_roi[_many] and the full frames of
render_xyz (a window at origin (0, 0)), all through render_xyz_windows.
`rasterize_attr` is the plain PyTorch render of any C attribute channels.

Meshes and poses come in as numpy arrays (or tensors); renders come back
as f32 tensors on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from gdrnet_tpu_torch.ops import kernels


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def _faces(faces, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(faces, np.int32) if not torch.is_tensor(faces) else faces,
                           device=device)


def rasterize_attr(verts, attrs, faces, K, R, t, *, height: int, width: int,
                   z_near: float = kernels.Z_NEAR, origin=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a mesh under pose (R, t) through intrinsics K, in plain PyTorch
    on the device of `verts` (the CPU for numpy inputs).

    verts [V,3] object-frame vertices; attrs [V,C] per-vertex attributes;
    faces [F,3] int. origin: optional (ox, oy) pixel offset: the [height,
    width] output then covers image pixels [oy:oy+height, ox:ox+width].
    Returns (depth [H,W], attr_map [H,W,C]); depth 0 means no hit.
    """
    dev = verts.device if torch.is_tensor(verts) else torch.device("cpu")
    org = torch.zeros(1, 2) if origin is None else torch.tensor([[origin[0], origin[1]]])
    depth, amap = kernels.rasterize_attr_ref(
        _f32(verts, dev), _f32(attrs, dev), _faces(faces, dev), _f32(K, dev)[None],
        _f32(R, dev)[None], _f32(t, dev)[None], org.to(dev, torch.float32), height, width,
        z_near)
    return depth[0], amap[0]


def render_xyz_windows(verts, faces, Ks, Rs, ts, origins, height: int, width: int,
                       device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Depth [N,H,W] and XYZ [N,H,W,3] of one mesh under N poses, pose n
    over the H x W window whose top-left pixel is origins[n], in one
    kernels.rasterize_xyz call on `device`."""
    dev = torch.device(device)
    return kernels.rasterize_xyz(
        _f32(verts, dev), _faces(faces, dev), _f32(Ks, dev), _f32(Rs, dev), _f32(ts, dev),
        _f32(origins, dev).contiguous(), height, width)


def render_xyz(verts, faces, K, R, t, height: int, width: int, device="cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Object-coordinate XYZ map [H,W,3] + depth [H,W] of the full frame
    under pose (R, t) — the GT the reference generates by GL render +
    backprojection (tools/lm/lm_pbr_1_gen_xyz_crop.py:98-207)."""
    depth, xyz = render_xyz_windows(verts, faces, np.asarray(K)[None], np.asarray(R)[None],
                                    np.asarray(t)[None], np.zeros((1, 2), np.float32),
                                    height, width, device)
    return depth[0], xyz[0]


def render_depth(verts, faces, K, R, t, height: int, width: int, device="cuda"
                 ) -> torch.Tensor:
    """Depth-only render (for VSD eval, lib/pysixd/pose_error.vsd:22)."""
    return render_xyz(verts, faces, K, R, t, height, width, device)[0]


def xyz_crop_from_render(depth, xyz) -> dict:
    """Crop the rendered XYZ map to the mask bbox — the `{xyz_crop, xyxy}`
    artifact layout of the reference tools (lm_pbr_1_gen_xyz_crop.py:186-207).
    """
    depth = depth.cpu().numpy() if torch.is_tensor(depth) else np.asarray(depth)
    xyz = xyz.cpu().numpy() if torch.is_tensor(xyz) else np.asarray(xyz)
    ys, xs = np.nonzero(depth > 0)
    if len(ys) == 0:
        return {"xyz_crop": np.zeros((0, 0, 3), np.float16), "xyxy": (0, 0, 0, 0)}
    x1, x2 = int(xs.min()), int(xs.max())
    y1, y2 = int(ys.min()), int(ys.max())
    crop = xyz[y1:y2 + 1, x1:x2 + 1].astype(np.float16)
    return {"xyz_crop": crop, "xyxy": (x1, y1, x2, y2)}


def window_origin(verts32, K, R, t, height: int, width: int,
                  tile: int) -> tuple[int, int] | None:
    """Origin of a [tile, tile] pixel window containing the whole projected
    mesh, clamped to the frame; None if the projection doesn't fit (numpy,
    as gdrnet_tpu/ops/rasterizer.py:274-289)."""
    K32 = np.asarray(K, np.float32)
    cam = np.asarray(verts32, np.float32) @ np.asarray(R, np.float32).T \
        + np.asarray(t, np.float32)
    uv = cam @ K32.T
    u = uv[:, 0] / np.maximum(uv[:, 2], 1e-4)
    v = uv[:, 1] / np.maximum(uv[:, 2], 1e-4)
    x1 = int(np.clip(np.floor(u.min()) - 1, 0, max(width - tile, 0)))
    y1 = int(np.clip(np.floor(v.min()) - 1, 0, max(height - tile, 0)))
    if (float(u.max()) - x1 + 2 > tile) or (float(v.max()) - y1 + 2 > tile):
        return None
    return x1, y1


def render_xyz_roi(verts, faces, K, R, t, height: int, width: int, tile: int = 256,
                   device="cuda"):
    """Windowed XYZ render: rasterize only a [tile, tile] pixel window around
    the projected object instead of the full frame, with the same sampling.

    Returns (depth [tile,tile], xyz [tile,tile,3], (ox, oy) int window
    origin). Pixels outside the image bounds render (validly) but callers
    pasting into a frame should clip. If the projection exceeds `tile`,
    raises ValueError — pick a bigger tile.
    """
    org = window_origin(verts, K, R, t, height, width, tile)
    if org is None:
        raise ValueError(f"projection exceeds tile {tile}")
    depth, xyz = render_xyz_windows(verts, faces, np.asarray(K)[None], np.asarray(R)[None],
                                    np.asarray(t)[None], np.asarray([org], np.float32),
                                    tile, tile, device)
    return depth[0], xyz[0], org


def paste_window(full, win, origin):
    """Paste a rendered window into a full frame (clipping image bounds);
    both numpy arrays or both tensors."""
    ox, oy = origin
    h, w = win.shape[:2]
    H, W = full.shape[:2]
    y2, x2 = min(oy + h, H), min(ox + w, W)
    full[oy:y2, ox:x2] = win[:y2 - oy, :x2 - ox]
    return full


def render_xyz_roi_many(verts, faces, Ks, Rs, ts, height: int, width: int, tile: int = 128,
                        on_misfit: str = "raise", device="cuda"):
    """Windowed XYZ renders of ONE mesh under many poses, all in one
    rasterize_xyz launch (the offline GT generator's and VSD's hot loop; the
    reference renders sequentially with GL, lm_pbr_1_gen_xyz_crop.py:98-207).

    Ks/Rs/ts: [N, 3, 3], [N, 3, 3], [N, 3]. Returns a list of N
    (depth [tile, tile], xyz [tile, tile, 3], (ox, oy)) tuples, tensors on
    `device`. Poses whose projection exceeds `tile`: on_misfit="raise"
    raises ValueError; "skip" instead returns (outputs, fitted_indices) with
    outputs only for the poses that fit.
    """
    verts32 = np.asarray(verts, np.float32)
    Ks = np.asarray(Ks, np.float32)
    Rs = np.asarray(Rs, np.float32)
    ts = np.asarray(ts, np.float32)
    origins = [window_origin(verts32, Ks[i], Rs[i], ts[i], height, width, tile)
               for i in range(len(Rs))]
    too_big = [i for i, org in enumerate(origins) if org is None]
    if too_big and on_misfit == "raise":
        raise ValueError(f"poses exceed tile {tile}: {too_big}")
    fitted = [i for i, org in enumerate(origins) if org is not None]
    out = []
    if fitted:
        orgs = np.asarray([origins[i] for i in fitted], np.float32)
        d, x = render_xyz_windows(verts32, faces, Ks[fitted], Rs[fitted], ts[fitted], orgs,
                                  tile, tile, device)
        out = [(d[k], x[k], origins[i]) for k, i in enumerate(fitted)]
    if on_misfit == "skip":
        return out, fitted
    return out
