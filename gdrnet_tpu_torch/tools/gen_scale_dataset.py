"""Multi-thousand-image synthetic BOP dataset generator on the port (the
counterpart of tools/gen_scale_dataset.py, which writes the flagship's synth
dataset, configs/gdrn/synth/a6_cPnP_synth.py:1-3).

Writes the artifact set the reference's offline pipeline builds with GL
(tools/lm/lm_pbr_1_gen_xyz_crop.py, lib/meshrenderer/scenerenderer.py) and
its datasets expect (core/gdrn_modeling/datasets/lm_pbr.py BOP layout):

  <root>/models/obj_XXXXXX.ply + models_info.json + fps_points.pkl
  <root>/<split>/<scene>/rgb|depth|mask|mask_visib|xyz_crop/...
  <root>/<split>/<scene>/scene_gt|scene_gt_info|scene_camera.json
  <root>/test_bboxes/est_dets.json   (jittered GT boxes + dropouts + FPs)
  <root>/meta.json                   (resolved by data.dataset_factory:
                                      names "<dirname>_train"/"<dirname>_test")

The same numpy RNG streams as the JAX tool, so one seed gives the same
scenes. Every instance of a chunk of images is rendered grouped by object,
in batches of up to 32 poses a B2 launch of 12 per-pose attribute channels
(ops/rasterizer.render_phong_xyz_roi_many: Phong colour and XYZ GT from one
z-buffer pass) on `--device`, the card unless `--device cpu`; the host
composites the windows, adds background and noise, and writes PNGs
(data/io.write_png) and the xyz_crop pickles. Each scene is written into a
hidden directory and renamed when complete, so a crashed run resumes at the
first unfinished scene. A render error raises.

Usage:
  python -m gdrnet_tpu_torch.tools.gen_scale_dataset --root datasets/BOP_DATASETS/synth \
      --train-images 2000 --test-images 400 [--seed 1] [--imgs-per-scene 200] \
      [--device cpu]
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import shutil
import time

import numpy as np
import torch

from gdrnet_tpu_torch.data.io import write_png
from gdrnet_tpu_torch.data.ply import save_ply
from gdrnet_tpu_torch.data.scene_renderer import random_rotation
from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.rasterizer import render_phong_xyz_roi_many, window_origin
from gdrnet_tpu_torch.tools import entry_device
from gdrnet_tpu_torch.tools.compute_fps import compute_fps_dict

W_DEF, H_DEF = 640, 480
K_DEF = np.array([[572.4114, 0, 320.0], [0, 573.57043, 240.0], [0, 0, 1.0]],
                 np.float32)

_TET = np.array([[0.0, 0.0, 0.0], [1.0, 0.12, 0.0],
                 [0.12, 1.0, 0.0], [0.12, 0.12, 1.0]], np.float32)
_TET_F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)


def _rz(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _box_vf(hx, hy, hz, center=(0.0, 0.0, 0.0)):
    c = np.asarray(center, np.float32)
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32) + c
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _pyramid_vf(half_base, h):
    b = half_base
    v = np.array([[-b, -b, 0], [b, -b, 0], [b, b, 0], [-b, b, 0],
                  [0, 0, h]], np.float32)
    v[:, 2] -= h / 3.0  # roughly center
    f = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                  [0, 2, 1], [0, 3, 2]], np.int32)
    return v, f


def _prism_vf(n, r, h):
    ang = 2 * np.pi * np.arange(n) / n
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    v = np.concatenate([
        np.concatenate([ring, np.full((n, 1), -h / 2)], -1),
        np.concatenate([ring, np.full((n, 1), h / 2)], -1)], 0).astype(np.float32)
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n + j], [i, n + j, n + i]]  # side quads
    for i in range(1, n - 1):  # bottom/top fans
        f += [[0, i + 1, i], [n, n + i, n + i + 1]]
    return v, np.asarray(f, np.int32)


def _octa_vf(r):
    v = r * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def _wedge_vf(hx, hy, hz):
    v = np.array([[-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz],
                  [-hx, hy, -hz], [-hx, -hy, hz], [-hx, hy, hz]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2],          # bottom
                  [0, 1, 4], [1, 5, 4],          # slope (x+ down to x-)
                  [1, 2, 5],                      # side
                  [2, 3, 5], [0, 4, 3], [3, 4, 5]], np.int32)
    return v, f


def _subdivide(v, f):
    """One round of midpoint (loop-topology) subdivision: each triangle ->
    4, edge midpoints deduped. Geometry is unchanged (flat faces stay flat)
    and declared symmetries stay EXACTLY true of the vertex set: boundary
    edges map to boundary edges under the symmetry group and triangulation
    diagonals' midpoints are face centers, which map to face centers."""
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    mid: dict[tuple, int] = {}
    verts = list(v)

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid:
            mid[key] = len(verts)
            verts.append((v[a] + v[b]) / 2.0)
        return mid[key]

    out = []
    for a, b, c in f:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts, np.float32), np.asarray(out, np.int32)


def _densify(v, f, min_verts=80, max_rounds=3):
    for _ in range(max_rounds):
        if len(v) >= min_verts:
            break
        v, f = _subdivide(v, f)
    return v, f


def _merge(a_vf, b_vf):
    (va, fa), (vb, fb) = a_vf, b_vf
    return np.concatenate([va, vb]), np.concatenate([fa, fb + len(va)])


def _add_landmarks(v, f, pos, size, sym_rots=()):
    """Append a small floating tetrahedron at `pos` plus one image under each
    declared symmetry rotation: the vertex set's symmetry group then equals
    exactly {I} ∪ sym_rots — ADD distinguishes all other poses while the
    declared symmetries stay true of the mesh (CLAUDE.md fixture rule)."""
    tet = pos[None] + size * _TET
    for Rg in [np.eye(3, dtype=np.float32)] + list(sym_rots):
        base = len(v)
        v = np.concatenate([v, tet @ Rg.T.astype(np.float32)])
        f = np.concatenate([f, base + _TET_F])
    return v.astype(np.float32), f.astype(np.int32)


def mesh_zoo():
    """[(name, verts[m], faces, sym_rots list)] — 10 objects, 4 symmetric."""
    zoo = []

    def add(name, vf, lm_pos, lm_size, syms=()):
        v, f = _add_landmarks(*vf, np.asarray(lm_pos, np.float32), lm_size,
                              syms)
        # densify so fps64 keypoints exist (NUM_REGIONS=64 configs) and
        # ADD's per-vertex mean has a real sample size
        v, f = _densify(v, f)
        zoo.append((name, v, f, list(syms)))

    r90, r180, r270 = _rz(90), _rz(180), _rz(270)
    add("cube", _box_vf(0.035, 0.035, 0.035), (0.015, 0.006, -0.012), 0.012)
    add("brick", _box_vf(0.06, 0.03, 0.02), (0.03, 0.012, -0.007), 0.010,
        syms=[r180])
    add("plate", _box_vf(0.05, 0.04, 0.008), (0.02, 0.015, 0.0), 0.008)
    add("tower", _box_vf(0.018, 0.018, 0.05), (0.009, 0.004, 0.02), 0.007,
        syms=[r90, r180, r270])
    add("pyramid", _pyramid_vf(0.04, 0.06), (0.012, 0.008, -0.01), 0.010)
    add("lblock", _merge(_box_vf(0.05, 0.02, 0.015),
                         _box_vf(0.02, 0.05, 0.015, (0.03, 0.03, 0.0))),
        (-0.02, 0.005, 0.0), 0.009)
    add("wedge", _wedge_vf(0.045, 0.03, 0.025), (-0.02, 0.01, 0.0), 0.010)
    add("octa", _octa_vf(0.035), (0.01, 0.005, 0.01), 0.009)
    add("bar", _box_vf(0.075, 0.012, 0.012), (0.04, 0.005, 0.004), 0.007,
        syms=[r180])
    add("hexprism", _prism_vf(6, 0.03, 0.05), (0.013, 0.006, 0.015), 0.008,
        syms=[r180])
    return zoo


def _object_colors(n, seed=7):
    rng = np.random.RandomState(seed)
    cols = 0.25 + 0.7 * rng.rand(n, 3)
    cols[:, rng.randint(3)] *= 0.8
    return cols.astype(np.float32)




def write_models(root, zoo):
    mdir = osp.join(root, "models")
    os.makedirs(mdir, exist_ok=True)
    models_info = {}
    for oid, (name, v, f, syms) in enumerate(zoo, start=1):
        save_ply(osp.join(mdir, f"obj_{oid:06d}.ply"), v * 1000.0, f)
        mins, maxs = v.min(0) * 1000.0, v.max(0) * 1000.0
        info = {
            "diameter": float(max(np.linalg.norm(
                v[i] - v, axis=-1).max() for i in range(len(v))) * 1000.0),
            "min_x": float(mins[0]), "min_y": float(mins[1]),
            "min_z": float(mins[2]),
            "size_x": float(maxs[0] - mins[0]),
            "size_y": float(maxs[1] - mins[1]),
            "size_z": float(maxs[2] - mins[2]),
        }
        if syms:
            mats = []
            for Rg in syms:
                m = np.eye(4, dtype=np.float64)
                m[:3, :3] = Rg
                mats.append(m.reshape(-1).tolist())
            info["symmetries_discrete"] = mats
        models_info[str(oid)] = info
    with open(osp.join(mdir, "models_info.json"), "w") as fp:
        json.dump(models_info, fp)
    # fps_points.pkl — the region-head keypoint artifact every BOP models
    # dir carries (reference 1_compute_fps.py)
    fps_dict = compute_fps_dict(mdir, list(range(1, len(zoo) + 1)))
    with open(osp.join(mdir, "fps_points.pkl"), "wb") as fp:
        pickle.dump(fps_dict, fp)
    return models_info


def sample_scene(rng, zoo, K, width, height, min_n=4, max_n=8, radius=0.62):
    """Random instance set: object ids (duplicates encouraged), separated
    frustum-bounded poses (reference scenerenderer.py:81-107 semantics),
    one light per scene."""
    n = int(rng.randint(min_n, max_n + 1))
    obj_is = rng.choice(len(zoo), n)
    if n >= 2 and rng.rand() < 0.5:
        obj_is[1] = obj_is[0]  # guarantee duplicate-object scenes often
    Rs, ts, ts_norm = [], [], []
    for k in range(n):
        for attempt in range(100):
            tz = rng.triangular(radius * 2 / 3, radius, radius * 4 / 3)
            tx = rng.uniform(-0.33 * tz * width / K[0, 0], 0.33 * tz * width / K[0, 0])
            ty = rng.uniform(-0.33 * tz * height / K[1, 1], 0.33 * tz * height / K[1, 1])
            t = np.array([tx, ty, tz], np.float32)
            tn = t / np.linalg.norm(t)
            if attempt < 99 and ts_norm and np.any(np.asarray(ts_norm) @ tn > 0.997):
                continue
            R = random_rotation(rng)
            # reject poses whose projected window can't fit the largest
            # render tile (close-ups protruding past the frame edge where
            # the clamped window origin can't slide further): a non-fitting
            # pose would fail _render_chunk, and the per-scene RNG would
            # fail again on every resume
            fits = window_origin(zoo[int(obj_is[k])][1], K, R, t, height, width, 512)
            if attempt < 99 and fits is None:
                continue
            if fits is None:
                t = np.array([0.0, 0.0, radius * 4 / 3], np.float32)
                tn = t / np.linalg.norm(t)
            ts_norm.append(tn)
            ts.append(t)
            Rs.append(R)
            break
    light = {
        "light_pos": np.asarray(
            [rng.uniform(-2, 2), rng.uniform(-2, 2), rng.uniform(-1.5, 0.5)], np.float32),
        "ambient": np.float32(rng.uniform(0.35, 0.55)),
        "diffuse": np.float32(rng.uniform(0.6, 1.0)),
        "specular": np.float32(rng.uniform(0.1, 0.4)),
    }
    return obj_is, np.stack(Rs), np.stack(ts), light


def _render_chunk(zoo, colors, images, K, width, height, tiles=(128, 256, 512), device="cuda"):
    """images: list of (obj_is, Rs, ts, light). Renders every instance of the
    chunk grouped by object in batched single-pass phong+xyz windows, each
    pose on the smallest tile of `tiles` that holds it.
    Returns {(img_idx, inst_idx): (depth_win, rgb_win, xyz_win, origin)}."""
    by_obj: dict[int, list] = {}
    for ii, (obj_is, Rs, ts, light) in enumerate(images):
        for k, oi in enumerate(obj_is):
            by_obj.setdefault(int(oi), []).append((ii, k, Rs[k], ts[k], light))
    out = {}
    for oi, insts in by_obj.items():
        _, v, f, _ = zoo[oi]
        col = np.broadcast_to(colors[oi], (len(v), 3))
        pend = list(range(len(insts)))
        for tile in tiles:
            if not pend:
                break
            Rs = np.stack([insts[i][2] for i in pend])
            ts = np.stack([insts[i][3] for i in pend])
            Ks = np.broadcast_to(K, (len(pend), 3, 3))
            lp = np.stack([insts[i][4]["light_pos"] for i in pend])
            amb = np.asarray([insts[i][4]["ambient"] for i in pend])
            dif = np.asarray([insts[i][4]["diffuse"] for i in pend])
            spec = np.asarray([insts[i][4]["specular"] for i in pend])
            rendered, fitted = render_phong_xyz_roi_many(
                v, f, Ks, Rs, ts, height, width, tile=tile, batch=32, colors=col,
                light_pos=lp, ambient=amb, diffuse=dif, specular=spec, on_misfit="skip",
                device=device)
            for pos, (d, rgb, xyz, org) in zip(fitted, rendered):
                ii, k = insts[pend[pos]][0], insts[pend[pos]][1]
                out[(ii, k)] = (d, rgb, xyz, org)
            fit = set(fitted)
            pend = [pend[i] for i in range(len(pend)) if i not in fit]
        if pend:
            raise ValueError(f"obj {oi}: {len(pend)} poses exceed largest tile {tiles[-1]}")
    return out


def _synth_bg(rng, height, width):
    """Cheap varied background: 2-color gradient + noise."""
    c0 = rng.rand(3) * 0.7
    c1 = rng.rand(3) * 0.7 + 0.2
    ramp = np.linspace(0, 1, height)[:, None, None]
    if rng.rand() < 0.5:
        ramp = np.linspace(0, 1, width)[None, :, None]
    bg = c0 + ramp * (c1 - c0)
    bg = bg + rng.randn(height, width, 3) * 0.03
    return np.clip(np.broadcast_to(bg, (height, width, 3)), 0, 1)


class _Clock:
    """Host-clock seconds by stage, summed over a split."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now


def generate_split(root, split, zoo, colors, K, width, height, n_images, seed,
                   images_per_scene=200, first_scene=1, chunk_imgs=32, log_every=128,
                   device="cuda") -> dict:
    """Writes `n_images` images of <root>/<split>, scene by scene. Returns
    the host-clock seconds of each stage (sample: the poses; render: the
    chunks' renders, which end in the copy of their outputs to the host;
    composite: the z-merge, boxes and masks; pickle: the xyz_crop writes;
    background: the synthetic background and noise; png) and B2's launches
    and the chunks."""
    n_scenes = -(-n_images // images_per_scene)
    img_global = 0
    clock = _Clock()
    launches, chunks = kernels.rasterize_attr.launches, 0
    for s in range(n_scenes):
        scene_id = first_scene + s
        sdir = osp.join(root, split, f"{scene_id:06d}")
        n_here = min(images_per_scene, n_images - s * images_per_scene)
        # per-scene RNG + completed-scene skip => a crashed run resumes
        # deterministically at the first unfinished scene
        rng = np.random.RandomState(seed + scene_id * 9973)
        gt_path = osp.join(sdir, "scene_gt.json")
        if osp.exists(gt_path):
            with open(gt_path) as f:
                if len(json.load(f)) == n_here:
                    img_global += n_here
                    print(f"[{split}] scene {scene_id} complete, skipping", flush=True)
                    continue
        # render into a hidden tmp dir and rename on completion: dataset
        # consumers enumerate <split>/<scene>/ dirs, so a scene must never be
        # visible without its scene_gt.json
        wdir = osp.join(osp.dirname(sdir), f".tmp_{scene_id:06d}")
        if osp.isdir(wdir):
            shutil.rmtree(wdir)
        for sub in ("rgb", "depth", "mask", "mask_visib", "xyz_crop"):
            os.makedirs(osp.join(wdir, sub), exist_ok=True)
        scene_gt, scene_gt_info, scene_camera = {}, {}, {}
        for c0 in range(0, n_here, chunk_imgs):
            ims = [sample_scene(rng, zoo, K, width, height)
                   for _ in range(min(chunk_imgs, n_here - c0))]
            clock.lap("sample")
            wins = _render_chunk(zoo, colors, ims, K, width, height, device=device)
            chunks += 1
            clock.lap("render")
            for ii, (obj_is, Rs, ts, light) in enumerate(ims):
                im_id = c0 + ii
                # composite in the renderer's on-disk dtypes (u16 mm / u8)
                depth_full = np.zeros((height, width), np.uint16)
                rgb_full = np.zeros((height, width, 3), np.uint8)
                inst_map = np.full((height, width), -1, np.int32)
                n_inst = len(obj_is)
                amodal = []
                for k in range(n_inst):
                    d, rgb, xyz, (ox, oy) = wins[(ii, k)]
                    h, w = d.shape
                    y2, x2 = min(oy + h, height), min(ox + w, width)
                    sub = np.s_[oy:y2, ox:x2]
                    dw = d[:y2 - oy, :x2 - ox]
                    cw = rgb[:y2 - oy, :x2 - ox]
                    closer = (dw > 0) & ((depth_full[sub] == 0) | (dw < depth_full[sub]))
                    depth_full[sub] = np.where(closer, dw, depth_full[sub])
                    rgb_full[sub] = np.where(closer[..., None], cw, rgb_full[sub])
                    inst_map[sub] = np.where(closer, k, inst_map[sub])
                    amodal.append((dw > 0, (ox, oy), xyz[:y2 - oy, :x2 - ox]))

                gts, infos = [], []
                keep_any = False
                for k in range(n_inst):
                    mask_a, (ox, oy), xyz = amodal[k]
                    mask_v = inst_map == k
                    n_all, n_vis = int(mask_a.sum()), int(mask_v.sum())
                    if n_all == 0:
                        n_all = 1
                    ysv, xsv = np.nonzero(mask_v)
                    if len(ysv):
                        bb_v = [int(xsv.min()), int(ysv.min()),
                                int(xsv.max() - xsv.min() + 1), int(ysv.max() - ysv.min() + 1)]
                    else:
                        bb_v = [0, 0, 0, 0]
                    ysa, xsa = np.nonzero(mask_a)
                    x1a, y1a = int(xsa.min()), int(ysa.min())
                    x2a, y2a = int(xsa.max()), int(ysa.max())
                    bb_a = [ox + x1a, oy + y1a, x2a - x1a + 1, y2a - y1a + 1]
                    # full-frame mask pngs (BOP mask/ + mask_visib/)
                    m_full = np.zeros((height, width), np.uint8)
                    m_full[oy:oy + mask_a.shape[0], ox:ox + mask_a.shape[1]] = mask_a * 255
                    m_visib = (mask_v * 255).astype(np.uint8)
                    clock.lap("composite")
                    with open(osp.join(wdir, "xyz_crop", f"{im_id:06d}_{k:06d}.pkl"), "wb") as fp:
                        pickle.dump({"xyz_crop": xyz[y1a:y2a + 1, x1a:x2a + 1],
                                     "xyxy": (ox + x1a, oy + y1a, ox + x2a, oy + y2a)}, fp)
                    clock.lap("pickle")
                    write_png(osp.join(wdir, "mask", f"{im_id:06d}_{k:06d}.png"), m_full)
                    write_png(osp.join(wdir, "mask_visib", f"{im_id:06d}_{k:06d}.png"), m_visib)
                    clock.lap("png")
                    gts.append({"cam_R_m2c": Rs[k].reshape(-1).astype(float).tolist(),
                                "cam_t_m2c": (ts[k] * 1000.0).astype(float).tolist(),
                                "obj_id": int(obj_is[k]) + 1})
                    infos.append({"bbox_obj": bb_a, "bbox_visib": bb_v,
                                  "px_count_all": n_all, "px_count_visib": n_vis,
                                  "visib_fract": float(n_vis / n_all)})
                    keep_any = keep_any or n_vis > 0
                if not keep_any:
                    raise ValueError(f"empty image {scene_id}/{im_id}")

                bg = (_synth_bg(rng, height, width) * 255.0).astype(np.uint8)
                out = np.where(depth_full[..., None] > 0, rgb_full, bg)
                noise = rng.randn(height, width, 3) * (0.015 * 255.0)
                out = np.clip(out.astype(np.float32) + noise, 0, 255).astype(np.uint8)
                clock.lap("background")
                write_png(osp.join(wdir, "rgb", f"{im_id:06d}.png"), out)
                write_png(osp.join(wdir, "depth", f"{im_id:06d}.png"), depth_full)
                clock.lap("png")
                scene_gt[str(im_id)] = gts
                scene_gt_info[str(im_id)] = infos
                scene_camera[str(im_id)] = {"cam_K": np.asarray(K, float).reshape(-1).tolist(),
                                            "depth_scale": 1.0}
                img_global += 1
                if img_global % log_every == 0:
                    print(f"[{split}] {img_global}/{n_images} images", flush=True)
        for fname, obj in (("scene_gt.json", scene_gt), ("scene_gt_info.json", scene_gt_info),
                           ("scene_camera.json", scene_camera)):
            with open(osp.join(wdir, fname), "w") as fp:
                json.dump(obj, fp)
        if osp.isdir(sdir):  # partial tree left by a pre-atomic-rename run
            shutil.rmtree(sdir)
        os.rename(wdir, sdir)
        clock.lap("composite")
    stats = {"seconds": clock.seconds, "b2_launches": kernels.rasterize_attr.launches - launches,
             "chunks": chunks}
    print(f"[{split}] done: {img_global} images, {n_scenes} scenes; host-clock s by stage "
          f"{json.dumps({k: round(v, 3) for k, v in clock.seconds.items()})}; "
          f"B2 launches {stats['b2_launches']} in {chunks} chunks", flush=True)
    return stats


def write_detections(root, split, seed, drop_prob=0.05, fp_prob=0.3):
    """Estimated detections: jittered GT visib boxes with dropouts and false
    positives — the provided-detections analogue (reference
    dataset_utils.load_detections_into_dataset consumes the same format)."""
    rng = np.random.RandomState(seed + 777)
    dets = []
    split_dir = osp.join(root, split)
    for scene in sorted(os.listdir(split_dir)):
        sdir = osp.join(split_dir, scene)
        with open(osp.join(sdir, "scene_gt.json")) as f:
            scene_gt = json.load(f)
        with open(osp.join(sdir, "scene_gt_info.json")) as f:
            scene_info = json.load(f)
        n_obj_ids = max(g["obj_id"] for gts in scene_gt.values() for g in gts)
        for im_id, gts in scene_gt.items():
            for g, info in zip(gts, scene_info[im_id]):
                if info["visib_fract"] <= 0.05:
                    continue  # detector can't see it; stays a recall miss
                if rng.rand() < drop_prob:
                    continue
                x, y, w, h = info["bbox_visib"]
                sw, sh = w * rng.uniform(0.9, 1.1), h * rng.uniform(0.9, 1.1)
                cx = x + w / 2 + w * rng.uniform(-0.05, 0.05)
                cy = y + h / 2 + h * rng.uniform(-0.05, 0.05)
                dets.append({
                    "scene_id": int(scene), "im_id": int(im_id), "obj_id": int(g["obj_id"]),
                    "bbox_est": [float(cx - sw / 2), float(cy - sh / 2), float(sw), float(sh)],
                    "score": float(np.clip(rng.normal(0.85, 0.08), 0.3, 1.0)),
                    "time": 0.05})
            if rng.rand() < fp_prob:  # false positive
                w = rng.uniform(40, 120)
                h = rng.uniform(40, 120)
                dets.append({
                    "scene_id": int(scene), "im_id": int(im_id),
                    "obj_id": int(rng.randint(1, n_obj_ids + 1)),
                    "bbox_est": [float(rng.uniform(0, 500)), float(rng.uniform(0, 350)),
                                 float(w), float(h)],
                    "score": float(rng.uniform(0.1, 0.5)), "time": 0.05})
    os.makedirs(osp.join(root, "test_bboxes"), exist_ok=True)
    path = osp.join(root, "test_bboxes", "est_dets.json")
    with open(path, "w") as fp:
        json.dump(dets, fp)
    print(f"wrote {len(dets)} detections -> {path}", flush=True)
    return path


def write_meta(root, zoo, models_info, K, width, height):
    meta = {
        "name": osp.basename(root.rstrip("/")),
        "objects": [z[0] for z in zoo],
        "id2obj": {i + 1: z[0] for i, z in enumerate(zoo)},
        "diameters": {z[0]: models_info[str(i + 1)]["diameter"] / 1000.0
                      for i, z in enumerate(zoo)},
        "cam_K": np.asarray(K, float).reshape(-1).tolist(),
        "width": width, "height": height,
        "sym_objects": [z[0] for z in zoo if z[3]],
    }
    with open(osp.join(root, "meta.json"), "w") as fp:
        json.dump(meta, fp, indent=1)
    return meta


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--test-images", type=int, default=400)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--width", type=int, default=W_DEF)
    p.add_argument("--height", type=int, default=H_DEF)
    p.add_argument("--imgs-per-scene", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="where the renders run: cuda (the default) or cpu")
    args = p.parse_args(argv)
    # thousands of renders: without the card, stop here rather than fall
    # back to the host
    device = entry_device("gen_scale_dataset", args.device)

    zoo = mesh_zoo()
    colors = _object_colors(len(zoo))
    K = K_DEF.copy()
    K[0, 2] = args.width / 2.0
    K[1, 2] = args.height / 2.0

    os.makedirs(args.root, exist_ok=True)
    models_info = write_models(args.root, zoo)
    meta = write_meta(args.root, zoo, models_info, K, args.width, args.height)
    print(f"meta: {meta['name']} objects={meta['objects']} sym={meta['sym_objects']}",
          flush=True)
    t0 = time.time()
    if args.train_images:
        generate_split(args.root, "train", zoo, colors, K, args.width, args.height,
                       args.train_images, seed=args.seed, images_per_scene=args.imgs_per_scene,
                       first_scene=1, device=device)
    if args.test_images:
        generate_split(args.root, "test", zoo, colors, K, args.width, args.height,
                       args.test_images, seed=args.seed + 5000,
                       images_per_scene=args.imgs_per_scene, first_scene=101, device=device)
        write_detections(args.root, "test", seed=args.seed)
    print(f"total {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
