"""Synthetic fixed-shape ROI batches (numpy), channels-last, and the port's
scoring fixtures.

synthetic_roi_batch, synthetic_raw_batch and synthetic_decoded_maps are copies of
gdrnet_tpu/data/synthetic.py's, which cannot be imported without JAX
(gdrnet_tpu.data's package import pulls it in). The copies must stay equal;
tests/test_torch_slice.py and tests/test_torch_pnp.py hold them to it.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np
import torch


def _random_rotations(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform random rotations via QR of gaussian matrices."""
    A = rng.randn(n, 3, 3)
    Q, R = np.linalg.qr(A)
    d = np.sign(np.diagonal(R, axis1=-2, axis2=-1))
    Q = Q * d[:, None, :]
    det = np.linalg.det(Q)
    Q[:, :, 0] *= det[:, None]
    return Q.astype(np.float32)


def synthetic_roi_batch(batch_size: int = 8, input_res: int = 256,
                        out_res: int = 64, num_classes: int = 13,
                        num_points: int = 512, num_regions: int = 8,
                        sym_k: int = 4, seed: int = 0,
                        img_w: int = 640, img_h: int = 480) -> dict:
    """Returns a dict of numpy arrays (channels-last) covering every input
    of the GDRN train step."""
    rng = np.random.RandomState(seed)
    B = batch_size

    K = np.tile(np.asarray(
        [[572.4114, 0, 325.2611], [0, 573.5704, 242.0490], [0, 0, 1]],
        np.float32), (B, 1, 1))

    rot = _random_rotations(rng, B)
    z = rng.uniform(0.5, 1.2, B).astype(np.float32)
    cx = rng.uniform(200, 440, B).astype(np.float32)
    cy = rng.uniform(140, 340, B).astype(np.float32)
    tx = (cx - K[:, 0, 2]) * z / K[:, 0, 0]
    ty = (cy - K[:, 1, 2]) * z / K[:, 1, 1]
    trans = np.stack([tx, ty, z], axis=1)

    # DZI-style square ROI: center jittered off centroid, scale ~ bbox*1.5
    bw = rng.uniform(64, 160, B).astype(np.float32)
    bh = rng.uniform(64, 160, B).astype(np.float32)
    bx = cx + rng.uniform(-0.1, 0.1, B).astype(np.float32) * bw
    by = cy + rng.uniform(-0.1, 0.1, B).astype(np.float32) * bh
    scale = (np.maximum(bw, bh) * 1.5).astype(np.float32)
    resize_ratio = (out_res / scale).astype(np.float32)

    # SITE targets (reference data_loader.py:628-632)
    trans_ratio = np.stack(
        [(cx - bx) / bw, (cy - by) / bh, z / resize_ratio], axis=1).astype(np.float32)

    extents = rng.uniform(0.05, 0.15, (B, 3)).astype(np.float32)
    points = (rng.rand(B, num_points, 3).astype(np.float32) - 0.5) * extents[:, None, :]
    fps = (rng.rand(B, num_regions, 3).astype(np.float32) - 0.5) * extents[:, None, :]

    # blocky object mask in the center of the 64x64 ROI + consistent labels
    ys, xs = np.mgrid[0:out_res, 0:out_res]
    masks = np.zeros((B, out_res, out_res), np.float32)
    xyz = np.zeros((B, out_res, out_res, 3), np.float32)
    region = np.zeros((B, out_res, out_res), np.int32)
    for i in range(B):
        r = out_res // 4 + rng.randint(0, out_res // 4)
        c0 = out_res // 2 + rng.randint(-4, 4)
        m = ((np.abs(ys - c0) < r) & (np.abs(xs - c0) < r)).astype(np.float32)
        masks[i] = m
        # fake normalized xyz in [0,1] inside the mask
        g = np.stack([xs / out_res, ys / out_res,
                      0.5 + 0.2 * np.sin(xs / 7.0)], axis=-1).astype(np.float32)
        xyz[i] = g * m[..., None]
        # region = nearest fps point of the denormalized coords
        coords = (xyz[i] - 0.5) * extents[i]
        d = np.linalg.norm(coords[..., None, :] - fps[i][None, None], axis=-1)
        region[i] = (np.argmin(d, axis=-1) + 1) * m.astype(np.int32)

    xyz_bin = np.clip((xyz * 64).astype(np.int32), 0, 63)

    sym_rots = np.tile(np.eye(3, dtype=np.float32), (B, sym_k, 1, 1))
    sym_mask = np.zeros((B, sym_k), bool)
    sym_mask[:, 0] = True

    coord2d = np.stack(np.meshgrid(
        np.linspace(0, 1, out_res, dtype=np.float32),
        np.linspace(0, 1, out_res, dtype=np.float32)), axis=-1)

    return {
        "roi_img": rng.rand(B, input_res, input_res, 3).astype(np.float32),
        "roi_classes": rng.randint(0, num_classes, B).astype(np.int32),
        "roi_coord_2d": np.tile(coord2d[None], (B, 1, 1, 1)),
        "roi_cams": K,
        "roi_centers": np.stack([bx, by], axis=1),
        "roi_whs": np.stack([bw, bh], axis=1),
        "roi_extents": extents,
        "resize_ratios": resize_ratio,
        "gt_xyz": xyz,
        "gt_xyz_bin": xyz_bin,
        "gt_mask_trunc": masks,
        "gt_mask_visib": masks,
        "gt_mask_obj": masks,
        "gt_region": region,
        "gt_ego_rot": rot,
        "gt_trans": trans,
        "gt_trans_ratio": trans_ratio,
        "gt_points": points,
        "sym_rots": sym_rots,
        "sym_mask": sym_mask,
    }


def synthetic_raw_batch(batch_size: int = 8, img_h: int = 96, img_w: int = 128,
                        num_classes: int = 2, seed: int = 0) -> tuple[dict, dict]:
    """Raw full-frame batch in the GDRNRawTrainMapper contract (uint8 image,
    f16 xyz, uint8 masks, bbox / pose / K / class) plus the per-class stacks
    device_train_batch gathers from, numpy (a copy of JAX's, bit for bit
    from the same seed)."""
    rng = np.random.RandomState(seed)
    B = batch_size
    K = np.tile(np.asarray(
        [[120.0, 0, img_w / 2], [0, 120.0, img_h / 2], [0, 0, 1]],
        np.float32), (B, 1, 1))
    rot = _random_rotations(rng, B)
    trans = np.stack([rng.uniform(-0.02, 0.02, B), rng.uniform(-0.02, 0.02, B),
                      rng.uniform(0.5, 0.8, B)], axis=1).astype(np.float32)

    imgs = rng.randint(0, 255, (B, img_h, img_w, 3), np.uint8)
    xyz = np.zeros((B, img_h, img_w, 3), np.float16)
    mv = np.zeros((B, img_h, img_w), np.uint8)
    bbox = np.zeros((B, 4), np.float32)
    for i in range(B):
        x1 = rng.randint(8, img_w // 2)
        y1 = rng.randint(8, img_h // 2)
        x2 = x1 + rng.randint(16, img_w // 3)
        y2 = y1 + rng.randint(12, img_h // 3)
        xyz[i, y1:y2, x1:x2] = (rng.rand(y2 - y1, x2 - x1, 3) * 0.1 - 0.05
                                ).astype(np.float16)
        mv[i, y1:y2, x1:x2] = 1
        bbox[i] = [x1, y1, x2 - 1, y2 - 1]

    C, N, F, Ksym = num_classes, 64, 8, 4
    stacks = {
        "points_stack": (rng.rand(C, N, 3).astype(np.float32) - 0.5) * 0.1,
        "extents_stack": np.full((C, 3), 0.1, np.float32),
        "fps_stack": (rng.rand(C, F, 3).astype(np.float32) - 0.5) * 0.1,
        "sym_rots_stack": np.tile(np.eye(3, dtype=np.float32), (C, Ksym, 1, 1)),
        "sym_mask_stack": np.concatenate(
            [np.ones((C, 1), bool), np.zeros((C, Ksym - 1), bool)], axis=1),
    }
    raw = {
        "image": imgs, "xyz": xyz, "mask_visib": mv, "mask_trunc": mv.copy(),
        "bbox": bbox, "gt_ego_rot": rot, "gt_trans": trans, "roi_cams": K,
        "roi_classes": rng.randint(0, C, B).astype(np.int32),
    }
    return raw, stacks


def synthetic_decoded_maps(rng: np.random.RandomState, batch_size: int = 1,
                           h: int = 64, w: int = 64, mask_frac: float = 0.6,
                           noise_px: float = 0.0, t_jitter: float = 0.0):
    """Synthetic decoded geometry maps in the tester's contract: per-ROI
    xyz_norm ([0,1] over the extent), coord2d (full-image fraction) and a
    random visibility mask, with the true (R, t) that generated them.
    Shared by the PnP tests, tools/bench_pnp.py and chip_smoke.py's [pnp],
    so that the map conventions (coord2d normalization, xyz centering) live
    in one place.

    Returns (mask [B,h,w], xyz_norm [B,h,w,3], coord2d [B,h,w,2],
    R [B,3,3], t [B,3], K [3,3], extent [3], (im_w, im_h))."""
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]],
                 np.float32)
    extent = np.array([0.2, 0.2, 0.2], np.float32)
    im_w, im_h = 640, 480
    B = batch_size
    R = _random_rotations(rng, B)
    t = (np.array([0.02, -0.01, 0.7], np.float32) +
         rng.randn(B, 3).astype(np.float32) * t_jitter)
    p3 = ((rng.rand(B, h * w, 3) - 0.5) * extent).astype(np.float32)
    pc = p3 @ np.swapaxes(R, 1, 2) + t[:, None]      # camera-frame points
    uv = pc @ K.T
    uv = uv[..., :2] / uv[..., 2:3]
    if noise_px:
        uv = uv + rng.randn(B, h * w, 2) * noise_px
    mask = (rng.rand(B, h, w) < mask_frac).astype(np.float32)
    xyz_norm = (p3 / extent + 0.5).reshape(B, h, w, 3).astype(np.float32)
    coord2d = (uv / [im_w, im_h]).reshape(B, h, w, 2).astype(np.float32)
    return mask, xyz_norm, coord2d, R, t, K, extent, (im_w, im_h)


# ---------------------------------------------------------------------------
# scoring fixtures (port only): object models and GT poses near predictions
# ---------------------------------------------------------------------------


def _axis_angle(axes: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rodrigues for [n, 3] unit axes and [n] angles -> [n, 3, 3]."""
    K = np.zeros((len(axes), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axes[:, 2], axes[:, 1], -axes[:, 0]
    K = K - np.transpose(K, (0, 2, 1))
    s, c = np.sin(angles)[:, None, None], np.cos(angles)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def synthetic_object_models(obj_names: list[str], sym_objs: list[str],
                            num_points: int = 3000, seed: int = 0):
    """Box-shaped objects for the evaluator: per object `num_points` points
    [N, 3] in metres, its diameter, and for each symmetric object a discrete
    k-fold symmetry about z as [k-1, 3, 3], k cycling through 2, 4, 2, 2 (the
    folds of brick, tower, bar and hexprism in tools/gen_scale_dataset.py).
    Returns (model_points, diameters, sym_rots) dicts."""
    rng = np.random.RandomState(seed)
    points, diameters, sym_rots = {}, {}, {}
    for name in obj_names:
        extent = rng.uniform(0.05, 0.2, 3)
        points[name] = ((rng.rand(num_points, 3) - 0.5) * extent).astype(np.float32)
        diameters[name] = float(np.linalg.norm(extent))
    for i, name in enumerate(sym_objs):
        k = (2, 4, 2, 2)[i % 4]
        angles = 2 * np.pi * np.arange(1, k) / k
        sym_rots[name] = _axis_angle(np.tile([[0.0, 0.0, 1.0]], (k - 1, 1)),
                                     angles).astype(np.float32)
    return points, diameters, sym_rots


def poses_near(R: np.ndarray, t: np.ndarray, seed: int = 0, max_deg: float = 15.0,
               t_sigma: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
    """GT poses scattered around [B,3,3] / [B,3] poses: a rotation by up to
    max_deg about a random axis and gaussian translation noise (metres), so
    that every recall threshold sees poses on both sides of it."""
    rng = np.random.RandomState(seed)
    B = len(R)
    axes = rng.randn(B, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dR = _axis_angle(axes, np.deg2rad(rng.uniform(0, max_deg, B)))
    R_gt = (np.asarray(R, np.float64) @ dR).astype(np.float32)
    t_gt = (np.asarray(t, np.float64) + rng.randn(B, 3) * t_sigma).astype(np.float32)
    return R_gt, t_gt


# ---------------------------------------------------------------------------
# hard z-buffer inputs (port only): faces seen edge-on, sliver faces
# ---------------------------------------------------------------------------


def edge_on_poses(half: float, depths=(0.4, 0.6, 0.5, 0.3)) -> tuple[np.ndarray, np.ndarray]:
    """Four poses R = I, t [4, 3] of a box of half extent `half` about its
    origin (mesh_zoo's cube: 0.035) that put some of its face planes through
    the camera centre: faces x = +half and y = -half or +half project to a
    line, up to the projection's rounding, or (the last two poses, moved by
    1e-7 and 3e-8 of `half`) to slivers a few ulps wide."""
    t = np.array([[-half, -half, depths[0]], [-half, half, depths[1]],
                  [half * (1 + 1e-7), -half, depths[2]], [-half, -half * (1 - 3e-8), depths[3]]],
                 np.float32)
    return np.stack([np.eye(3, dtype=np.float32)] * 4), t


def sliver_mesh(K: np.ndarray, n: int = 150, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """n near-degenerate faces (verts [3n, 3] f32, faces [n, 3] int32) for a
    camera with intrinsics K at R = I, t = 0: each has a vertex within 1e-6
    to 1e-3 px of a pixel centre of x in [210, 260), y in [160, 210), and
    runs 0.5 to 6 px from it with its third vertex as little off the line;
    one in three lies along a viewing ray (seen edge-on)."""
    rs = np.random.RandomState(seed)
    K = np.asarray(K, np.float64)
    vs, fs = [], []
    for k in range(n):
        scale = 10.0 ** rs.uniform(-6, -3)
        c = np.array([rs.randint(210, 260), rs.randint(160, 210)], np.float64)
        d = rs.randn(2)
        d *= rs.uniform(0.5, 6.0) / np.linalg.norm(d)
        uv = np.stack([c, c + d, c + 0.5 * d]) + scale * rs.randn(3, 2)
        z = np.full(3, rs.uniform(0.4, 0.8))
        if k % 3 == 0:
            uv[1:] = uv[0] + scale * rs.randn(2, 2)
            z = z * np.array([1.0, 1.1, 1.2])
        vs.append(np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0] * z,
                            (uv[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1))
        fs.append([3 * k, 3 * k + 1, 3 * k + 2])
    return np.concatenate(vs).astype(np.float32), np.array(fs, np.int32)


def lattice_cloud(m: int, step: float = 0.01) -> np.ndarray:
    """An m x m x m grid of float32 points about the origin, [m**3, 3]: the
    farthest point sampler's distances tie exactly, point after point."""
    g = (np.arange(m) - (m - 1) / 2) * step
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)


def cylinder_cloud(n_around: int = 96, n_high: int = 40, radius: float = 0.05,
                   step: float = 0.01) -> np.ndarray:
    """n_high rings of n_around float32 points, [n_around * n_high, 3]; each
    ring is one quadrant turned by 90 degrees three times (exact in floats),
    the rings symmetric about z = 0, so the sampler's distances tie exactly.
    n_around is a multiple of 4."""
    a = np.arange(n_around // 4) * (2 * np.pi / n_around)
    c, s = (radius * np.cos(a)).astype(np.float32), (radius * np.sin(a)).astype(np.float32)
    ring = np.concatenate([np.stack(q, -1) for q in ((c, s), (-s, c), (-c, -s), (s, -c))])
    z = ((np.arange(n_high) - (n_high - 1) / 2) * step).astype(np.float32)
    return np.concatenate([np.concatenate([ring, np.full((len(ring), 1), h, np.float32)], 1)
                           for h in z])


# ---------------------------------------------------------------------------
# BOP-layout split (port only): the scoring and training fixture of chip_smoke.py
# ---------------------------------------------------------------------------


def _mesh_diameter_mm(v: np.ndarray) -> float:
    """Largest vertex-to-vertex distance, mm (tools/gen_scale_dataset.py:210)."""
    return float(max(np.linalg.norm(v[i] - v, axis=-1).max() for i in range(len(v))) * 1000.0)


def write_bop_split(root: str, meshes: list, obj_idx: np.ndarray, R: np.ndarray,
                    t: np.ndarray, K: np.ndarray, width: int = 640, height: int = 480,
                    per_image: int = 8, images_per_scene: int = 8, device="cuda",
                    split: str = "test", with_xyz_crop: bool = False):
    """Write a BOP-layout dataset with one split (`split`: "test", "train")
    holding the given instances, as tools/gen_scale_dataset.py lays its
    datasets out: models/obj_XXXXXX.ply (mm) + models_info.json (diameter,
    extents, symmetries_discrete), meta.json, and <split>/<scene>/ with
    scene_gt.json, scene_gt_info.json, scene_camera.json, rgb/*.png, 16-bit
    depth/*.png (mm, depth_scale 1), and per instance mask/ and mask_visib/
    PNGs ({im}_{inst}.png, 0 or 255) and, with `with_xyz_crop`, the
    xyz_crop/{im}_{inst}.pkl of ops.rasterizer.xyz_crop_from_render.

    meshes: [(name, verts [V,3] m, faces [F,3], sym_rots list)] as
    tools/gen_scale_dataset.py:mesh_zoo returns them. Instance n (object
    meshes[obj_idx[n]] at R[n], t[n] in metres, intrinsics K) goes to scene
    n // (per_image * images_per_scene) + 1, image (n // per_image) %
    images_per_scene. Each image's depth is the z-merge of its instances'
    depth renders (ops.rasterizer, so the z-buffer kernel on a CUDA
    `device`); the visible masks of scene_gt_info and mask_visib/ follow
    from it.

    Returns (DatasetMeta of `root`, [N, 2] int (scene_id, im_id) of each
    instance)."""
    from gdrnet_tpu_torch.data.io import save_depth, write_png
    from gdrnet_tpu_torch.data.ply import save_ply
    from gdrnet_tpu_torch.data.ref_meta import meta_from_json
    from gdrnet_tpu_torch.eval.vsd import render_depths_many
    from gdrnet_tpu_torch.ops.rasterizer import render_xyz, xyz_crop_from_render

    obj_idx = np.asarray(obj_idx)
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    K = np.asarray(K, np.float32)
    N = len(obj_idx)
    mdir = osp.join(root, "models")
    os.makedirs(mdir, exist_ok=True)
    models_info = {}
    for oid, (name, v, f, syms) in enumerate(meshes, start=1):
        save_ply(osp.join(mdir, f"obj_{oid:06d}.ply"), v * 1000.0, f)
        mins, maxs = v.min(0) * 1000.0, v.max(0) * 1000.0
        info = {"diameter": _mesh_diameter_mm(v),
                "min_x": float(mins[0]), "min_y": float(mins[1]), "min_z": float(mins[2]),
                "size_x": float(maxs[0] - mins[0]), "size_y": float(maxs[1] - mins[1]),
                "size_z": float(maxs[2] - mins[2])}
        if syms:
            mats = []
            for Rg in syms:
                m = np.eye(4)
                m[:3, :3] = Rg
                mats.append(m.reshape(-1).tolist())
            info["symmetries_discrete"] = mats
        models_info[str(oid)] = info
    with open(osp.join(mdir, "models_info.json"), "w") as fp:
        json.dump(models_info, fp)
    meta = {"name": osp.basename(root.rstrip("/")),
            "objects": [m[0] for m in meshes],
            "id2obj": {i + 1: m[0] for i, m in enumerate(meshes)},
            "diameters": {m[0]: models_info[str(i + 1)]["diameter"] / 1000.0
                          for i, m in enumerate(meshes)},
            "cam_K": K.astype(float).reshape(-1).tolist(), "width": width, "height": height,
            "sym_objects": [m[0] for m in meshes if m[3]]}
    with open(osp.join(root, "meta.json"), "w") as fp:
        json.dump(meta, fp, indent=1)

    # every instance's own full-frame depth, rendered object by object
    depths = torch.zeros(N, height, width, dtype=torch.float32, device=device)
    for o in np.unique(obj_idx):
        sel = np.nonzero(obj_idx == o)[0]
        _, v, f, _ = meshes[o]
        depths[sel] = render_depths_many(v, f, np.broadcast_to(K, (len(sel), 3, 3)), R[sel],
                                         t[sel], height, width, device=device)

    colors = (40 + 200 * np.random.RandomState(7).rand(len(meshes), 3)).astype(np.uint8)
    per_scene = per_image * images_per_scene
    keys = np.stack([np.arange(N) // per_scene + 1, (np.arange(N) // per_image)
                     % images_per_scene], axis=1)
    for s in range(0, N, per_scene):
        scene_dir = osp.join(root, split, f"{s // per_scene + 1:06d}")
        for sub in ("rgb", "depth", "mask", "mask_visib") + (("xyz_crop",) if with_xyz_crop else ()):
            os.makedirs(osp.join(scene_dir, sub), exist_ok=True)
        scene_gt, scene_gt_info, scene_camera = {}, {}, {}
        for s0 in range(s, min(s + per_scene, N), per_image):
            idx = np.arange(s0, min(s0 + per_image, N))
            im_id = int(keys[s0, 1])
            d = depths[idx]
            zmin, inst = torch.where(d > 0, d, torch.inf).min(dim=0)  # first instance on ties
            hit = torch.isfinite(zmin)
            inst_map = torch.where(hit, inst, -1)
            visib = inst_map[None] == torch.arange(len(idx), device=inst_map.device)[:, None, None]
            amodal = d > 0
            rows_a, cols_a = amodal.any(2).cpu().numpy(), amodal.any(1).cpu().numpy()
            rows_v, cols_v = visib.any(2).cpu().numpy(), visib.any(1).cpu().numpy()
            n_all = amodal.sum(dim=(1, 2)).cpu().numpy()
            n_vis = visib.sum(dim=(1, 2)).cpu().numpy()

            def bbox(rows, cols):
                ys, xs = np.nonzero(rows)[0], np.nonzero(cols)[0]
                if len(ys) == 0:
                    return [0, 0, 0, 0]
                return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                        int(ys.max() - ys.min() + 1)]

            gts, infos = [], []
            amodal_np, visib_np = amodal.cpu().numpy(), visib.cpu().numpy()
            for k, n in enumerate(idx):
                stem = f"{im_id:06d}_{k:06d}"
                write_png(osp.join(scene_dir, "mask", f"{stem}.png"),
                          amodal_np[k].astype(np.uint8) * 255)
                write_png(osp.join(scene_dir, "mask_visib", f"{stem}.png"),
                          visib_np[k].astype(np.uint8) * 255)
                if with_xyz_crop:
                    _, v, f, _ = meshes[obj_idx[n]]
                    crop = xyz_crop_from_render(*render_xyz(v, f, K, R[n], t[n], height, width,
                                                            device=device))
                    with open(osp.join(scene_dir, "xyz_crop", f"{stem}.pkl"), "wb") as fp:
                        pickle.dump(crop, fp)
                gts.append({"cam_R_m2c": R[n].reshape(-1).astype(float).tolist(),
                            "cam_t_m2c": (t[n] * 1000.0).astype(float).tolist(),
                            "obj_id": int(obj_idx[n]) + 1})
                infos.append({"bbox_obj": bbox(rows_a[k], cols_a[k]),
                              "bbox_visib": bbox(rows_v[k], cols_v[k]),
                              "px_count_all": int(n_all[k]), "px_count_visib": int(n_vis[k]),
                              "visib_fract": float(n_vis[k] / max(n_all[k], 1))})
            inst_np = inst_map.cpu().numpy()
            rgb = np.full((height, width, 3), 60, np.uint8)
            rgb[inst_np >= 0] = colors[obj_idx[idx][inst_np[inst_np >= 0]]]
            write_png(osp.join(scene_dir, "rgb", f"{im_id:06d}.png"), rgb)
            save_depth(osp.join(scene_dir, "depth", f"{im_id:06d}.png"),
                       torch.where(hit, zmin, 0.0).cpu().numpy())
            scene_gt[str(im_id)] = gts
            scene_gt_info[str(im_id)] = infos
            scene_camera[str(im_id)] = {"cam_K": K.astype(float).reshape(-1).tolist(),
                                        "depth_scale": 1.0}
        for fname, obj in (("scene_gt.json", scene_gt), ("scene_gt_info.json", scene_gt_info),
                           ("scene_camera.json", scene_camera)):
            with open(osp.join(scene_dir, fname), "w") as fp:
                json.dump(obj, fp)
    return meta_from_json(root), keys
