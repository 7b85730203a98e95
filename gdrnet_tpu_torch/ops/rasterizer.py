"""Triangle z-buffer renders of meshes (counterpart of
gdrnet_tpu/ops/rasterizer.py: rasterize_attr, render_xyz, render_depth,
window_origin, render_xyz_roi, render_xyz_roi_many, paste_window,
xyz_crop_from_render, vertex_normals, render_normals, render_phong,
render_phong_many, render_phong_xyz_roi_many, render_box3d, _phong_window,
render_scene).

Same design and conventions as the JAX module: an edge-function test of
every (pixel, face) pair with perspective-correct interpolation (attr/z and
1/z linear in screen space); the sample point of pixel (i, j) is (x=j, y=i),
with no half-pixel offset; the nearest face wins and ties go to the lowest
face index; depth 0 means no hit.

Every render here goes through the z-buffer kernel B2, which launches on a
CUDA `device` and runs its plain version on the CPU: the depth / XYZ
renders through ops.kernels.rasterize_xyz (the windows of
render_xyz_roi[_many] and the full frames of render_xyz, a window at origin
(0, 0), all through render_xyz_windows), the normal and Phong renders
through ops.kernels.rasterize_attr with per-pose attributes (camera
normal, camera position, material, and for the dataset generator's pass
the object coordinates: 12 channels in one launch). The Phong shading of
the reference's CAD shader is one function on tensors, `phong_shade`. The
3D box's line render is plain tensor code, as the JAX package computes it
in XLA outside any Pallas kernel.

Meshes and poses come in as numpy arrays (or tensors); renders come back
as f32 tensors on `device`, except where the JAX function returns numpy
(render_phong_many, render_phong_xyz_roi_many, render_scene).
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


def rasterize_attr(verts, attrs, faces, K, R, t, *, height: int, width: int, origin=None,
                   device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Render a mesh under pose (R, t) through intrinsics K on `device`, in
    one kernels.rasterize_attr call.

    verts [V,3] object-frame vertices; attrs [V,C] per-vertex attributes;
    faces [F,3] int. origin: optional (ox, oy) pixel offset: the [height,
    width] output then covers image pixels [oy:oy+height, ox:ox+width].
    Returns (depth [H,W], attr_map [H,W,C]); depth 0 means no hit.
    """
    dev = torch.device(device)
    org = [[0.0, 0.0]] if origin is None else [[origin[0], origin[1]]]
    depth, amap = kernels.rasterize_attr(
        _f32(verts, dev), _f32(attrs, dev)[None], _faces(faces, dev), _f32(K, dev)[None],
        _f32(R, dev)[None], _f32(t, dev)[None], _f32(org, dev), height, width)
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


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals on the host, in f64, returned as f32
    (a copy of gdrnet_tpu/ops/rasterizer.py:vertex_normals; what assimp
    supplies to the reference renderer)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(n, 1e-12)).astype(np.float32)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def render_normals(verts, faces, K, R, t, height: int, width: int, normals=None,
                   device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space unit-normal map [H,W,3] + depth [H,W] — the reference's
    meshrenderer_phong_normals.py output. Normals rotate by R only."""
    normals = vertex_normals(verts, faces) if normals is None else normals
    n_cam = np.asarray(normals, np.float32) @ np.asarray(R, np.float32).T
    depth, nmap = rasterize_attr(verts, n_cam, faces, K, R, t, height=height, width=width,
                                 device=device)
    return depth, torch.where(depth[..., None] > 0, _unit(nmap), 0.0)


# default material color of the reference CAD shader
# (lib/meshrenderer/shader/cad_shader.frag:21-23)
_CAD_MATERIAL = np.array([223.0, 214.0, 205.0], np.float32) / 255.0


def _material(colors, n_verts: int) -> np.ndarray:
    return (np.broadcast_to(_CAD_MATERIAL, (n_verts, 3)) if colors is None
            else np.asarray(colors, np.float32))


def phong_shade(amap: torch.Tensor, depth: torch.Tensor, light_pos, ambient, diffuse,
                specular) -> torch.Tensor:
    """The reference's directional Phong model (shader/cad_shader.frag:16-39:
    rgb = ambient*mat + diffuse*max(n.l,0)*mat + specular*max(reflect(-l,n).
    view,0)*mat, clipped to 1; light at `light_pos` in the camera frame,
    viewer at the origin), in the JAX package's order of operations
    (gdrnet_tpu/ops/rasterizer.py:236-249).

    amap [..., H, W, >=9]: interpolated camera normal, camera position and
    material; depth [..., H, W]; light_pos [3] or [..., 3] and the weights
    scalars or [...], one per leading index. Returns rgb [..., H, W, 3] in
    [0, 1], 0 where depth is 0."""
    def per_pose(x, tail: int):
        x = torch.as_tensor(np.asarray(x, np.float32), device=amap.device)
        return x.reshape(x.shape[:x.dim() - tail] + (1, 1) + x.shape[x.dim() - tail:])

    n = _unit(amap[..., 0:3])
    p = amap[..., 3:6]
    c = amap[..., 6:9]
    light = _unit(per_pose(light_pos, 1) - p)
    v = _unit(-p)
    ndl = (n * light).sum(-1, keepdim=True).clamp_min(0.0)
    refl = 2.0 * ndl * n - light  # reflect(-l, n)
    rdv = (refl * v).sum(-1, keepdim=True).clamp_min(0.0)
    weight = lambda x: per_pose(x, 0)[..., None]  # noqa: E731
    rgb = (c * (weight(ambient) + weight(diffuse) * ndl + weight(specular) * rdv)).clamp(0.0, 1.0)
    return torch.where(depth[..., None] > 0, rgb, 0.0)


def render_phong(verts, faces, K, R, t, height: int, width: int, colors=None,
                 light_pos=(400.0, 400.0, 400.0), ambient: float = 0.4, diffuse: float = 0.8,
                 specular: float = 0.3, normals=None, origin=None, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phong-shaded RGB render + depth — the reference's EGL renderer
    (lib/meshrenderer/meshrenderer_phong.py:125-208) with `phong_shade`.

    colors: optional [V, 3] per-vertex material (PLY colour); default the
    CAD material constant. Returns (depth [H,W], rgb [H,W,3] in [0,1]).
    origin: optional (ox, oy) pixel offset for windowed rendering — the
    [height, width] output then covers image pixels [oy:oy+height,
    ox:ox+width]."""
    normals = vertex_normals(verts, faces) if normals is None else normals
    verts32 = np.asarray(verts, np.float32)
    R32 = np.asarray(R, np.float32)
    t32 = np.asarray(t, np.float32)
    n_cam = np.asarray(normals, np.float32) @ R32.T          # [V, 3]
    p_cam = verts32 @ R32.T + t32                            # [V, 3]
    attrs = np.concatenate([n_cam, p_cam, _material(colors, len(verts32))], -1)  # [V, 9]
    depth, amap = rasterize_attr(verts32, attrs, faces, K, R32, t32, height=height, width=width,
                                 origin=origin, device=device)
    return depth, phong_shade(amap, depth, light_pos, ambient, diffuse, specular)


def render_phong_many(verts, faces, K, Rs, ts, height: int, width: int,
                      random_light: bool = False, rng: np.random.RandomState | None = None,
                      device="cuda", **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """Sequential multi-pose render (meshrenderer_phong.py:209-320
    render_many): same mesh, many poses; optional per-call random light
    pose/intensities like the reference's domain randomization. Returns
    numpy depths [N,H,W] and rgbs [N,H,W,3]."""
    outs = []
    rng = rng or np.random.RandomState()
    for R, t in zip(Rs, ts):
        kw = dict(kwargs)
        if random_light:
            kw.setdefault("light_pos", 1000.0 * rng.random_sample(3))
            kw.setdefault("ambient", 0.4 + 0.1 * (2 * rng.random_sample() - 1))
            kw.setdefault("diffuse", 0.8 + 0.1 * (2 * rng.random_sample() - 1))
            kw.setdefault("specular", 0.3 + 0.1 * (2 * rng.random_sample() - 1))
        outs.append(render_phong(verts, faces, K, R, t, height, width, device=device, **kw))
    return (np.stack([d.cpu().numpy() for d, _ in outs]),
            np.stack([c.cpu().numpy() for _, c in outs]))


def render_phong_xyz_roi_many(verts, faces, Ks, Rs, ts, height: int, width: int,
                              tile: int = 128, batch: int = 32, colors=None, light_pos=None,
                              ambient=None, diffuse=None, specular=None, normals=None,
                              on_misfit: str = "raise", device="cuda"):
    """Batched windowed phong+XYZ renders of ONE mesh under many poses — the
    dataset generator's hot loop (gdrnet_tpu_torch/tools/gen_scale_dataset.py).
    One B2 launch per batch of <= `batch` poses renders 12 per-pose
    attribute channels (camera normal, camera position, material, object
    coordinates), so one pass yields both the shaded colour (what the
    reference's GL SceneRenderer draws, lib/meshrenderer/scenerenderer.py:
    70-140) and the XYZ GT (what tools/lm/lm_pbr_1_gen_xyz_crop.py renders
    again for); the shading and the quantization to the BOP on-disk dtypes
    (uint16 mm depth png, uint8 rgb png, f16 xyz_crop pkl) run on `device`.

    Ks [N,3,3], Rs [N,3,3], ts [N,3]; per-pose lighting arrays light_pos
    [N,3] / ambient / diffuse / specular [N] (defaults = render_phong's
    constants). Returns (list of (depth_mm uint16, rgb uint8, xyz f16,
    (ox, oy)) numpy tuples, fitted_indices) when on_misfit="skip", else the
    list alone (raises on misfit). The JAX package clamps `batch` so that
    its XLA z-buffer's [B, tile^2, chunk] intermediate stays near 4 GB
    (gdrnet_tpu/ops/rasterizer.py:524-529); B2 keeps no such intermediate,
    so `batch` is taken as given."""
    verts32 = np.asarray(verts, np.float32)
    normals = vertex_normals(verts32, faces) if normals is None else normals
    mat = _material(colors, len(verts32))
    Ks = np.asarray(Ks, np.float32)
    Rs = np.asarray(Rs, np.float32)
    ts = np.asarray(ts, np.float32)
    N = Rs.shape[0]
    if light_pos is None:
        light_pos = np.broadcast_to(np.array([400.0, 400.0, 400.0], np.float32), (N, 3))
    ambient = np.full(N, 0.4, np.float32) if ambient is None else np.asarray(ambient, np.float32)
    diffuse = np.full(N, 0.8, np.float32) if diffuse is None else np.asarray(diffuse, np.float32)
    specular = (np.full(N, 0.3, np.float32) if specular is None
                else np.asarray(specular, np.float32))
    light_pos = np.asarray(light_pos, np.float32)

    origins = [window_origin(verts32, Ks[i], Rs[i], ts[i], height, width, tile)
               for i in range(N)]
    too_big = [i for i, org in enumerate(origins) if org is None]
    if too_big and on_misfit == "raise":
        raise ValueError(f"poses exceed tile {tile}: {too_big}")
    fitted = [i for i, org in enumerate(origins) if org is not None]
    dev = torch.device(device)
    vt, ft = _f32(verts32, dev), _faces(faces, dev)
    out = []
    for s in range(0, len(fitted), batch):
        sel = np.asarray(fitted[s:s + batch], np.int64)
        # the JAX module's numpy expressions (rasterizer.py:535-540), so that
        # both packages feed the z-buffer the same bits
        n_cam = np.einsum("vk,bjk->bvj", normals, Rs[sel])
        p_cam = np.einsum("vk,bjk->bvj", verts32, Rs[sel]) + ts[sel][:, None]
        attrs = np.concatenate(
            [n_cam, p_cam, np.broadcast_to(mat, (len(sel),) + mat.shape),
             np.broadcast_to(verts32, (len(sel),) + verts32.shape)], -1)
        orgs = np.asarray([origins[i] for i in sel], np.float32)
        depth, amap = kernels.rasterize_attr(
            vt, _f32(np.ascontiguousarray(attrs), dev), ft, _f32(Ks[sel], dev),
            _f32(Rs[sel], dev), _f32(ts[sel], dev), _f32(orgs, dev), tile, tile)
        rgb = phong_shade(amap, depth, light_pos[sel], ambient[sel], diffuse[sel],
                          specular[sel])
        hit = depth[..., None] > 0
        # uint16 has few CUDA ops: the clamped integer millimetres cross as
        # int32 and are cast on the host, which changes no value
        depth_mm = (depth * 1000.0).round().clamp(0.0, 65535.0).to(torch.int32)
        rgb_u8 = (rgb * 255.0).round().to(torch.uint8)
        xyz_f16 = torch.where(hit, amap[..., 9:12], 0.0).to(torch.float16)
        depth_mm = depth_mm.cpu().numpy().astype(np.uint16)
        rgb_u8, xyz_f16 = rgb_u8.cpu().numpy(), xyz_f16.cpu().numpy()
        out += [(depth_mm[k], rgb_u8[k], xyz_f16[k], origins[i]) for k, i in enumerate(sel)]
    if on_misfit == "skip":
        return out, fitted
    return out


# 3D bounding-box edge corners in the reference line shader's order
# (lib/meshrenderer/shader/line.vs:18-43: 12 instanced GL_LINES between
# min/max-corner combinations). Each row indexes the corner bit pattern
# (bx, by, bz): 0 -> vert_min component, 1 -> vert_max component.
_BOX_EDGES = np.array([
    [(0, 0, 0), (0, 0, 1)], [(0, 0, 0), (0, 1, 0)], [(0, 0, 0), (1, 0, 0)],
    [(0, 0, 1), (0, 1, 1)], [(0, 0, 1), (1, 0, 1)], [(0, 1, 0), (0, 1, 1)],
    [(0, 1, 0), (1, 1, 0)], [(1, 0, 0), (1, 1, 0)], [(1, 0, 0), (1, 0, 1)],
    [(1, 1, 1), (0, 1, 1)], [(1, 1, 1), (1, 0, 1)], [(1, 1, 1), (1, 1, 0)],
], np.int32)  # [12, 2, 3]


def _rasterize_segments(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor,
                        height: int, width: int, half_width: float) -> torch.Tensor:
    """Distance-to-segment line rasterizer: pixels within `half_width` of
    any valid projected segment [p0_i, p1_i] are lit. Returns [H, W] bool."""
    dev = p0.device
    yy, xx = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    p = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).float()
    d = p1 - p0                                        # [S, 2]
    len2 = (d * d).sum(-1).clamp_min(1e-12)            # [S]
    rel = p[:, None, :] - p0[None]                     # [P, S, 2]
    tt = ((rel * d[None]).sum(-1) / len2[None]).clamp(0.0, 1.0)
    near = p0[None] + tt[..., None] * d[None]          # [P, S, 2]
    dist = torch.linalg.vector_norm(p[:, None] - near, dim=-1)
    dist = torch.where(valid[None], dist, torch.inf)
    return (dist.amin(dim=1) <= half_width).reshape(height, width)


def render_box3d(vert_min, vert_max, K, R, t, height: int, width: int,
                 line_width: float = 3.0, color=(0.0, 1.0, 0.0), z_near: float = 1e-4,
                 device="cuda") -> torch.Tensor:
    """Render the 12 edges of an object's 3D bounding box under pose (R, t)
    — the reference's GL box3d edge renderer (lib/meshrenderer/
    box3d_renderer.py:120-148 drawing 12 instanced GL_LINES between the
    min/max mesh corners with glLineWidth(3) (:113), shader/line.vs, all
    edges colored (0,1,0)).

    vert_min/vert_max: [3] object-frame AABB corners. Edges crossing the
    near plane are clipped to their visible part (GL clip-space line
    clipping), on the host in numpy as the JAX package does. Returns rgb
    [H, W, 3] f32 in [0, 1] on `device`, black background."""
    lo = np.asarray(vert_min, np.float32)
    hi = np.asarray(vert_max, np.float32)
    corners = np.where(_BOX_EDGES.reshape(-1, 3) == 1, hi, lo)  # [24, 3]
    cam = corners @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    a, b = cam[0::2], cam[1::2]                                 # [12, 3]
    za, zb = a[:, 2], b[:, 2]
    valid = (za > z_near) | (zb > z_near)
    # clip each endpoint behind the near plane to the z=z_near crossing
    denom = np.where(np.abs(zb - za) < 1e-12, 1e-12, zb - za)
    tt = np.clip((z_near - za) / denom, 0.0, 1.0)
    a = np.where((za <= z_near)[:, None], a + tt[:, None] * (b - a), a)
    b = np.where((zb <= z_near)[:, None], cam[0::2] + tt[:, None] * (b - cam[0::2]), b)
    K32 = np.asarray(K, np.float32)
    ua = a @ K32.T
    ub = b @ K32.T
    p0 = ua[:, :2] / np.maximum(ua[:, 2:3], z_near)             # [12, 2]
    p1 = ub[:, :2] / np.maximum(ub[:, 2:3], z_near)
    dev = torch.device(device)
    mask = _rasterize_segments(_f32(p0, dev), _f32(p1, dev), torch.as_tensor(valid, device=dev),
                               height, width, max(line_width, 1.0) / 2.0)
    return torch.where(mask[..., None], _f32(color, dev)[None, None], 0.0)


def _phong_window(verts, faces, K, R, t, height, width, tiles=(128, 256, 512), device="cuda",
                  **kwargs):
    """Windowed Phong render laddering tile sizes; falls back to the full
    frame if the projection exceeds every tile. Returns (depth, rgb,
    (ox, oy)) with window-sized outputs."""
    verts32 = np.asarray(verts, np.float32)
    for tile in tiles:
        if tile >= max(height, width):
            break
        org = window_origin(verts32, K, R, t, height, width, tile)
        if org is not None:
            d, rgb = render_phong(verts, faces, K, R, t, tile, tile, origin=org, device=device,
                                  **kwargs)
            return d, rgb, org
    d, rgb = render_phong(verts, faces, K, R, t, height, width, device=device, **kwargs)
    return d, rgb, (0, 0)


def render_scene(models, obj_is, K, Rs, ts, height: int, width: int,
                 random_light: bool = False, rng: np.random.RandomState | None = None,
                 tiles=(128, 256, 512), device="cuda") -> dict:
    """Composited multi-object scene render — the reference's
    SceneRenderer/render_many path (lib/meshrenderer/scenerenderer.py:70-140,
    meshrenderer_phong.py:209 render_many): each instance is Phong-rendered
    on `device` and z-merged into one frame on the host (nearest surface
    wins: a strict <, so the earlier instance keeps a tie), like the GL
    depth test across draws.

    models: list of (verts, faces) or (verts, faces, colors) meshes.
    obj_is: [N] int indices into `models`; Rs [N,3,3], ts [N,3].

    Returns a dict of numpy arrays: rgb [H,W,3] f32 in [0,1], depth [H,W]
    f32 (0 = no hit), inst_map [H,W] int32 (-1 = background, else instance
    index), bboxes [N,4] int xyxy of each instance's *visible* pixels (all
    -1 if fully occluded / off-screen), bboxes_amodal [N,4] int xyxy of each
    instance's own silhouette ignoring occlusion (what the reference's
    render_many returns per draw, meshrenderer_phong.py:209-320), and
    masks_visib [N,H,W] bool.
    """
    rng = rng or np.random.RandomState()
    depth_full = np.zeros((height, width), np.float32)
    rgb_full = np.zeros((height, width, 3), np.float32)
    inst_map = np.full((height, width), -1, np.int32)
    N = len(obj_is)
    bboxes_amodal = np.full((N, 4), -1, np.int64)
    kw = {}
    if random_light:  # ONE light per scene, shared by every draw (the
        # reference randomizes before the draw loop, render_many)
        kw["light_pos"] = 1000.0 * rng.random_sample(3)
        kw["ambient"] = 0.4 + 0.1 * (2 * rng.random_sample() - 1)
        kw["diffuse"] = 0.8 + 0.1 * (2 * rng.random_sample() - 1)
        kw["specular"] = 0.3 + 0.1 * (2 * rng.random_sample() - 1)
    for i in range(N):
        m = models[obj_is[i]]
        verts, faces = m[0], m[1]
        colors = m[2] if len(m) > 2 else None
        d_win, rgb_win, (ox, oy) = _phong_window(verts, faces, K, Rs[i], ts[i], height, width,
                                                 tiles=tiles, device=device, colors=colors, **kw)
        d_win, rgb_win = d_win.cpu().numpy(), rgb_win.cpu().numpy()
        h, w = d_win.shape
        y2, x2 = min(oy + h, height), min(ox + w, width)
        if y2 <= oy or x2 <= ox:
            continue
        sub = np.s_[oy:y2, ox:x2]
        dw = d_win[:y2 - oy, :x2 - ox]
        ys, xs = np.nonzero(dw > 0)
        if len(ys):
            bboxes_amodal[i] = (ox + xs.min(), oy + ys.min(), ox + xs.max(), oy + ys.max())
        cw = rgb_win[:y2 - oy, :x2 - ox]
        closer = (dw > 0) & ((depth_full[sub] == 0) | (dw < depth_full[sub]))
        depth_full[sub] = np.where(closer, dw, depth_full[sub])
        rgb_full[sub] = np.where(closer[..., None], cw, rgb_full[sub])
        inst_map[sub] = np.where(closer, i, inst_map[sub])
    bboxes = np.full((N, 4), -1, np.int64)
    masks = np.zeros((N, height, width), bool)
    for i in range(N):
        masks[i] = inst_map == i
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            bboxes[i] = (xs.min(), ys.min(), xs.max(), ys.max())
    return {"rgb": rgb_full, "depth": depth_full, "inst_map": inst_map,
            "bboxes": bboxes, "bboxes_amodal": bboxes_amodal, "masks_visib": masks}
