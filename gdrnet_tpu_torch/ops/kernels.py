"""Hand-written GPU kernels of the port, each beside its plain PyTorch version.

`nn_min_dist`: batched nearest-neighbour mean distance, the ADI / ADD-S core
(the counterpart of gdrnet_tpu/ops/pallas_kernels.py:nn_min_dist). On a CUDA
tensor it launches the CUDA kernel in csrc/nn_min_dist.cu; on a CPU tensor it
runs `nn_min_dist_ref`.

`rasterize_xyz`: the z-buffer depth + object-coordinate render of one mesh
under B poses over pixel windows (the counterpart of
gdrnet_tpu/ops/pallas_kernels.py:rasterize_xyz_pallas). On a CUDA tensor it
launches the CUDA kernels in csrc/rasterize_xyz.cu, which build the per-face
table on the device and cull faces per pixel tile; on a CPU tensor it runs
`rasterize_xyz_ref`, whose prologue `raster_face_tables` builds the same
table in PyTorch. `raster_tile_keep` is the plain version of the kernel's
per-tile culling rule.

Each wrapper's `launches` attribute counts its calls that launched the
wrapper's kernels; loader threads call rasterize_xyz concurrently, so the
count is bumped under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from gdrnet_tpu_torch import csrc

_REF_CHUNK_ELEMS = 1 << 24  # bounds the [B, chunk, NR, 3] difference tensor
_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper) -> None:
    """wrapper.launches += 1, exact under concurrent callers."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def nn_min_dist_ref(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """query [B,NQ,3], ref [B,NR,3] f32 -> [B] mean_q min_r |q - r|.

    Plain version: direct differences in f32, queries taken in chunks."""
    B, NQ, _ = query.shape
    NR = ref.shape[1]
    chunk = max(1, _REF_CHUNK_ELEMS // (B * NR * 3))
    total = torch.zeros(B, dtype=torch.float32, device=query.device)
    for s in range(0, NQ, chunk):
        d2 = (query[:, s:s + chunk, None, :] - ref[:, None, :, :]).square().sum(-1)
        total += d2.amin(dim=-1).sqrt().sum(dim=-1)
    return total / NQ


@functools.cache
def _nn_lib() -> ctypes.CDLL:
    lib = csrc.load("nn_min_dist")
    lib.nn_min_dist_query_tile.argtypes = []
    lib.nn_min_dist_query_tile.restype = ctypes.c_int
    lib.nn_min_dist_partial_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nn_min_dist_partial_sums.restype = ctypes.c_int
    lib.nn_min_dist_error_string.argtypes = [ctypes.c_int]
    lib.nn_min_dist_error_string.restype = ctypes.c_char_p
    return lib


def _check_point_sets(query: torch.Tensor, ref: torch.Tensor) -> None:
    for name, t in (("query", query), ("ref", ref)):
        if t.dtype != torch.float32:
            raise TypeError(f"nn_min_dist: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"nn_min_dist: {name} must be [B, N, 3], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nn_min_dist: {name} must be contiguous")
        if t.shape[1] < 1:
            raise ValueError(f"nn_min_dist: {name} holds no points")
    if query.shape[0] != ref.shape[0] or query.shape[0] < 1:
        raise ValueError("nn_min_dist: query and ref need the same batch size >= 1, "
                         f"got {query.shape[0]} and {ref.shape[0]}")
    if query.device != ref.device:
        raise ValueError(f"nn_min_dist: query on {query.device}, ref on {ref.device}")


def nn_min_dist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """query [B,NQ,3], ref [B,NR,3] f32 contiguous -> [B] mean_q min_r |q - r|.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    `nn_min_dist_ref`."""
    _check_point_sets(query, ref)
    if query.device.type == "cpu":
        return nn_min_dist_ref(query, ref)
    if query.device.type != "cuda":
        raise ValueError(f"nn_min_dist: no kernel for device {query.device}")
    B, NQ, _ = query.shape
    if B > 65535:
        raise ValueError(f"nn_min_dist: batch {B} exceeds the kernel's grid limit 65535")
    lib = _nn_lib()
    tile = lib.nn_min_dist_query_tile()
    partial = torch.empty((B, -(-NQ // tile)), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nn_min_dist_partial_sums(query.data_ptr(), ref.data_ptr(),
                                          partial.data_ptr(), B, NQ, ref.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"nn_min_dist kernel launch failed: "
                           f"{lib.nn_min_dist_error_string(rc).decode()} ({rc})")
    _count_launch(nn_min_dist)
    return partial.sum(dim=1) / NQ


nn_min_dist.launches = 0


# ---------------------------------------------------------------------------
# triangle rasterization (z-buffer)
# ---------------------------------------------------------------------------

Z_NEAR = 1e-4
_RASTER_ELEMS = 1 << 22  # bounds each [poses, pixels, faces] temporary of the plain version
_RASTER_FACE_CHUNK = 512


def _rows(M: torch.Tensor, k: int, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """Row k of [B,3,3] M times the vectors (a, b, c) [.., V]: f32 products
    summed left to right (no matmul, so no TF32 and no reordered sums)."""
    return M[:, k, 0:1] * a + M[:, k, 1:2] * b + M[:, k, 2:3] * c


def raster_face_tables(verts: torch.Tensor, attrs: torch.Tensor, faces: torch.Tensor,
                       K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       z_near: float = Z_NEAR) -> tuple[torch.Tensor, torch.Tensor]:
    """Screen-space table of every face under every pose, in f32: the
    per-face data that rasterize_xyz_pallas builds before its kernel
    (gdrnet_tpu/ops/pallas_kernels.py:244-264), with rasterize_attr's
    projection and validity test (gdrnet_tpu/ops/rasterizer.py:60-89).

    verts [V,3], attrs [V,C], faces [F,3] int, K and R [B,3,3], t [B,3] ->
      geom [B,F,12]: x0 y0 x1 y1 | x2 y2 inv_area valid | iz0 iz1 iz2 0
      attr [B,F,3C]: attr / z at vertex 0, then 1, then 2.
    A face is valid when its doubled screen area exceeds 1e-12 in magnitude
    and its three vertices lie beyond z_near; an invalid face has inv_area 0.
    """
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    cx = _rows(R, 0, x, y, z) + t[:, 0:1]                        # [B, V]
    cy = _rows(R, 1, x, y, z) + t[:, 1:2]
    cz = _rows(R, 2, x, y, z) + t[:, 2:3]
    uw = _rows(K, 2, cx, cy, cz).clamp_min(z_near)
    u = _rows(K, 0, cx, cy, cz) / uw
    v = _rows(K, 1, cx, cy, cz) / uw
    inv_z = 1.0 / cz.clamp_min(z_near)
    attrs_over_z = attrs[None] * inv_z[..., None]               # [B, V, C]

    f = faces.long()
    i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]
    x0, y0, x1, y1, x2, y2 = u[:, i0], v[:, i0], u[:, i1], v[:, i1], u[:, i2], v[:, i2]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = ((area.abs() > 1e-12) & (cz[:, i0] > z_near) & (cz[:, i1] > z_near)
             & (cz[:, i2] > z_near))
    inv_area = torch.where(valid, 1.0 / torch.where(valid, area, 1.0), 0.0)
    geom = torch.stack([x0, y0, x1, y1, x2, y2, inv_area, valid.float(),
                        inv_z[:, i0], inv_z[:, i1], inv_z[:, i2], torch.zeros_like(x0)], dim=-1)
    attr = torch.cat([attrs_over_z[:, i0], attrs_over_z[:, i1], attrs_over_z[:, i2]], dim=-1)
    return geom, attr


def zbuffer_ref(geom: torch.Tensor, attr: torch.Tensor, origins: torch.Tensor,
                height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain z-buffer over the tables of `raster_face_tables`: pixel (i, j)
    of pose b samples (j + origins[b, 0], i + origins[b, 1]). Returns depth
    [B,H,W] and attributes [B,H,W,C]; 0 where no face covers a pixel.

    Faces and pixels go in chunks (each [poses, pixels, faces] temporary
    stays near 2^22 elements). In a chunk the first arg-max of 1/z wins, and
    a later chunk replaces it only when strictly nearer, so ties go to the
    lowest face index (gdrnet_tpu/ops/rasterizer.py:104-116)."""
    B, F, _ = geom.shape
    C = attr.shape[-1] // 3
    P = height * width
    dev = geom.device
    fc = min(F, _RASTER_FACE_CHUNK)
    bc = max(1, min(B, _RASTER_ELEMS // (fc * 256)))  # poses, leaving >= 256 pixels a chunk
    pc = max(1, min(P, _RASTER_ELEMS // (bc * fc)))
    pix = torch.arange(P, device=dev)
    gx, gy = (pix % width).float(), (pix // width).float()
    depth = torch.empty(B, P, dtype=torch.float32, device=dev)
    out = torch.empty(B, P, C, dtype=torch.float32, device=dev)
    for b0 in range(0, B, bc):
        g_b, a_b = geom[b0:b0 + bc], attr[b0:b0 + bc]
        nb = g_b.shape[0]
        for p0 in range(0, P, pc):
            qx = (gx[None, p0:p0 + pc] + origins[b0:b0 + nb, 0:1])[..., None]  # [nb, pc, 1]
            qy = (gy[None, p0:p0 + pc] + origins[b0:b0 + nb, 1:2])[..., None]
            n = qx.shape[1]
            best = torch.zeros(nb, n, dtype=torch.float32, device=dev)
            bw0, bw1 = torch.zeros_like(best), torch.zeros_like(best)
            bface = torch.zeros(nb, n, dtype=torch.long, device=dev)
            for f0 in range(0, F, fc):
                g = g_b[:, None, f0:f0 + fc]                                  # [nb, 1, fc, 12]
                x0, y0, x1, y1 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
                x2, y2, inv_area, valid = g[..., 4], g[..., 5], g[..., 6], g[..., 7]
                w0 = ((x1 - qx) * (y2 - qy) - (y1 - qy) * (x2 - qx)) * inv_area
                w1 = ((x2 - qx) * (y0 - qy) - (y2 - qy) * (x0 - qx)) * inv_area
                w2 = 1.0 - w0 - w1
                inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (valid > 0)
                frag = torch.where(inside, w0 * g[..., 8] + w1 * g[..., 9] + w2 * g[..., 10], 0.0)
                k = frag.argmax(dim=-1, keepdim=True)                          # first maximum
                cand = frag.gather(-1, k)[..., 0]
                take = cand > best
                best = torch.where(take, cand, best)
                bw0 = torch.where(take, w0.gather(-1, k)[..., 0], bw0)
                bw1 = torch.where(take, w1.gather(-1, k)[..., 0], bw1)
                bface = torch.where(take, k[..., 0] + f0, bface)
            hit = best > 0
            safe = best.clamp_min(1e-12)
            a = a_b.gather(1, bface[..., None].expand(-1, -1, 3 * C))          # [nb, n, 3C]
            bw2 = 1.0 - bw0 - bw1
            val = (bw0[..., None] * a[..., 0:C] + bw1[..., None] * a[..., C:2 * C]
                   + bw2[..., None] * a[..., 2 * C:]) / safe[..., None]
            depth[b0:b0 + nb, p0:p0 + n] = torch.where(hit, 1.0 / safe, 0.0)
            out[b0:b0 + nb, p0:p0 + n] = torch.where(hit[..., None], val, 0.0)
    return depth.reshape(B, height, width), out.reshape(B, height, width, C)


def rasterize_attr_ref(verts, attrs, faces, K, R, t, origins, height: int, width: int,
                       z_near: float = Z_NEAR) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain z-buffer render of per-vertex attributes attrs [V,C] under B
    poses: depth [B,H,W] and the perspective-correct attribute map
    [B,H,W,C] (gdrnet_tpu/ops/rasterizer.py:rasterize_attr, batched)."""
    geom, attr = raster_face_tables(verts, attrs, faces, K, R, t, z_near)
    return zbuffer_ref(geom, attr, origins, height, width)


def rasterize_xyz_ref(verts, faces, K, R, t, origins, height: int, width: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `rasterize_xyz`: rasterize_attr_ref with attrs = verts."""
    return rasterize_attr_ref(verts, verts, faces, K, R, t, origins, height, width)


# The CUDA kernel's culling rule (csrc/rasterize_xyz.cu, "Culling"): a face is
# dropped from a tile only when it is invalid, or when one of its exact
# barycentrics lies below minus a bound on the f32 rounding error of that
# barycentric at all four corners of the tile's sample rectangle. The bound's
# constants, in f64: _CULL_GAMMA covers the five roundings of edge() then
# * inv_area (5u / (1 - 5u) < 6u, u = 2^-24) and the f64 evaluation,
# _CULL_W2 the two roundings of w2 = (1 - w0) - w1 (u (2 + u) < 3u), and
# _CULL_TINY the subnormal range (2^-150 per rounding).
RASTER_TILE = 16
_CULL_GAMMA = 6.0 * 2.0 ** -24
_CULL_W2 = 3.0 * 2.0 ** -24
_CULL_TINY = 2.0 ** -148


def _edge_cull(xa, ya, xb, yb, ia, abs_ia, px, py):
    """Exact barycentric ((xa - px)(yb - py) - (ya - py)(xb - px)) * ia at the
    four corners [.., 2, 2] (px, py each [.., 2]: the rectangle's low and
    high sample point) and its error bound E over the rectangle, in f64 and
    in the kernel's order of operations."""
    A, D = xa[..., None] - px, xb[..., None] - px          # [.., 2] over x
    Bv, Cv = yb[..., None] - py, ya[..., None] - py        # [.., 2] over y
    w = (Bv[..., :, None] * A[..., None, :] - Cv[..., :, None] * D[..., None, :]) \
        * ia[..., None, None]                              # [.., y, x]
    S = (A.abs().amax(-1) * Bv.abs().amax(-1)) + (Cv.abs().amax(-1) * D.abs().amax(-1))
    return w, (_CULL_GAMMA * abs_ia) * S + _CULL_TINY * (abs_ia + 1.0)


def raster_tile_keep(geom: torch.Tensor, origins: torch.Tensor, height: int, width: int,
                     tile: int = RASTER_TILE) -> torch.Tensor:
    """[B, ceil(H/tile), ceil(W/tile), F] bool: which faces of the table of
    `raster_face_tables` the CUDA kernel keeps for each tile x tile block of
    the window (the plain version of its culling rule, in f64).

    Pixel (i, j) of pose b samples the f32 point (j + origins[b, 0], i +
    origins[b, 1]); a tile's sample rectangle spans its first and last
    pixel inside the window. wk(p) = ((xa - px)(yb - py) - (ya - py)(xb - px))
    * inv_area is affine in p, so when wk < -Ek at the four corners it is
    below -Ek on the whole rectangle, and the f32 value the z-buffer
    computes, which differs from it by at most Ek, is negative: the face
    covers no pixel of the tile. Ek is the error bound of _CULL_* above, from
    the largest |xa - px|, |yb - py|, |ya - py|, |xb - px| on the rectangle.
    A near-degenerate face has a huge inv_area and so a huge bound: it is
    kept."""
    B, F, _ = geom.shape
    dev = geom.device
    j_lo = torch.arange(0, width, tile, device=dev)
    i_lo = torch.arange(0, height, tile, device=dev)
    j = torch.stack([j_lo, (j_lo + tile - 1).clamp_max(width - 1)], -1).float()  # [TX, 2]
    i = torch.stack([i_lo, (i_lo + tile - 1).clamp_max(height - 1)], -1).float()  # [TY, 2]
    keep = torch.empty(B, len(i_lo), len(j_lo), F, dtype=torch.bool, device=dev)
    for b in range(B):  # one pose at a time bounds the [TY, TX, F, 2, 2] temporaries
        px = (j + origins[b, 0]).double()[None, :, None, :]     # [1, TX, 1, 2]
        py = (i + origins[b, 1]).double()[:, None, None, :]     # [TY, 1, 1, 2]
        g = geom[b].double()
        x0, y0, x1, y1, x2, y2, ia = (g[:, k] for k in range(7))
        abs_ia = ia.abs()
        w0, e0 = _edge_cull(x1, y1, x2, y2, ia, abs_ia, px, py)
        w1, e1 = _edge_cull(x2, y2, x0, y0, ia, abs_ia, px, py)
        w2 = (1.0 - w0) - w1
        m0, m1 = w0.abs().flatten(-2).amax(-1), w1.abs().flatten(-2).amax(-1)
        e2 = (e0 + e1) + _CULL_W2 * (((1.0 + m0) + e0) + (m1 + e1))
        outside = ((w0 < -e0[..., None, None]).flatten(-2).all(-1)
                   | (w1 < -e1[..., None, None]).flatten(-2).all(-1)
                   | (w2 < -e2[..., None, None]).flatten(-2).all(-1))
        keep[b] = (g[:, 7] > 0) & ~outside
    return keep


@functools.cache
def _raster_lib() -> ctypes.CDLL:
    lib = csrc.load("rasterize_xyz")
    lib.rasterize_xyz_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.rasterize_xyz_launch.restype = ctypes.c_int
    lib.rasterize_xyz_tile.argtypes = []
    lib.rasterize_xyz_tile.restype = ctypes.c_int
    lib.rasterize_xyz_error_string.argtypes = [ctypes.c_int]
    lib.rasterize_xyz_error_string.restype = ctypes.c_char_p
    if lib.rasterize_xyz_tile() != RASTER_TILE:
        raise RuntimeError(f"rasterize_xyz.cu culls {lib.rasterize_xyz_tile()}-pixel tiles, "
                           f"raster_tile_keep {RASTER_TILE}")
    return lib


def _check_raster_inputs(verts, faces, K, R, t, origins, height, width) -> None:
    shapes = {"verts": (verts, None), "K": (K, (3, 3)), "R": (R, (3, 3)), "t": (t, (3,)),
              "origins": (origins, (2,))}
    for name, (x, tail) in shapes.items():
        if x.dtype != torch.float32:
            raise TypeError(f"rasterize_xyz: {name} must be float32, got {x.dtype}")
        if tail is not None and (x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail):
            raise ValueError(f"rasterize_xyz: {name} must be [B, {', '.join(map(str, tail))}], "
                             f"got {tuple(x.shape)}")
        if x.device != verts.device:
            raise ValueError(f"rasterize_xyz: {name} on {x.device}, verts on {verts.device}")
    if verts.dim() != 2 or verts.shape[1] != 3 or verts.shape[0] < 1:
        raise ValueError(f"rasterize_xyz: verts must be [V, 3], got {tuple(verts.shape)}")
    if faces.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rasterize_xyz: faces must be int32 or int64, got {faces.dtype}")
    if faces.dim() != 2 or faces.shape[1] != 3 or faces.shape[0] < 1:
        raise ValueError(f"rasterize_xyz: faces must be [F, 3], F >= 1, got {tuple(faces.shape)}")
    if faces.device != verts.device:
        raise ValueError(f"rasterize_xyz: faces on {faces.device}, verts on {verts.device}")
    B = K.shape[0]
    if B < 1 or R.shape[0] != B or t.shape[0] != B or origins.shape[0] != B:
        raise ValueError("rasterize_xyz: K, R, t and origins need one batch size >= 1, got "
                         f"{K.shape[0]}, {R.shape[0]}, {t.shape[0]}, {origins.shape[0]}")
    if not origins.is_contiguous():
        raise ValueError("rasterize_xyz: origins must be contiguous")
    if height < 1 or width < 1:
        raise ValueError(f"rasterize_xyz: empty window {height}x{width}")


def rasterize_xyz(verts: torch.Tensor, faces: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                  t: torch.Tensor, origins: torch.Tensor, height: int, width: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth [B,H,W] and object-coordinate XYZ [B,H,W,3] of the mesh
    (verts [V,3] f32, faces [F,3] int) under poses K, R [B,3,3], t [B,3],
    each over the H x W pixel window whose top-left pixel is origins[b]
    ([B,2] f32, integer valued). 0 where no face covers a pixel.

    CUDA tensors go through the CUDA kernels (or raise): two launches, the
    face setup and the z-buffer, with no PyTorch op between them (a face
    index outside [0, V) stops the setup kernel with a device-side fault, as
    PyTorch's own index kernels do). CPU tensors go through
    `rasterize_xyz_ref`."""
    _check_raster_inputs(verts, faces, K, R, t, origins, height, width)
    if verts.device.type == "cpu":
        return rasterize_xyz_ref(verts, faces, K, R, t, origins, height, width)
    if verts.device.type != "cuda":
        raise ValueError(f"rasterize_xyz: no kernel for device {verts.device}")
    B, V, F = K.shape[0], verts.shape[0], faces.shape[0]
    if B > 65535 or -(-height // RASTER_TILE) > 65535:
        raise ValueError(f"rasterize_xyz: batch {B} or height {height} exceeds the kernel's "
                         "grid limit")
    if max(V, F, height, width) >= 2 ** 31:
        raise ValueError(f"rasterize_xyz: {V} vertices, {F} faces or a {height}x{width} "
                         "window exceed the kernel's 32-bit counts")
    lib = _raster_lib()
    verts, faces, K, R, t = (x.contiguous() for x in (verts, faces, K, R, t))
    dev = verts.device
    geom = torch.empty((B, F, 12), dtype=torch.float32, device=dev)  # the setup's face table
    depth = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    xyz = torch.empty((B, height, width, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rasterize_xyz_launch(
            verts.data_ptr(), faces.data_ptr(), int(faces.dtype == torch.int64), K.data_ptr(),
            R.data_ptr(), t.data_ptr(), origins.data_ptr(), geom.data_ptr(), depth.data_ptr(),
            xyz.data_ptr(), B, V, F, height, width, Z_NEAR, stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_xyz kernel launch failed: "
                           f"{lib.rasterize_xyz_error_string(rc).decode()} ({rc})")
    _count_launch(rasterize_xyz)
    return depth, xyz


rasterize_xyz.launches = 0
