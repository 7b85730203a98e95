"""Dense XYZ-coordinate GT crops for a BOP split, rendered by the z-buffer
kernel (counterpart of tools/gen_xyz.py:30-150; the reference's GL tool
chain, tools/lm/lm_pbr_1_gen_xyz_crop.py:98-207, without OpenGL).

For every GT instance the mesh's object coordinates are rendered under the
GT pose, cropped to the mask's box and saved as a float16 {xyz_crop, xyxy}
pickle under <scene>/xyz_crop/, the file the train mapper reads instead of
rendering. The instances of a scene are grouped by object and rendered on
the tile ladder: every pose whose projection fits a 128-pixel window in one
B2 launch (ops/rasterizer.render_xyz_roi_many), then the rest that fit 256
in one more, then each that fits neither on the full frame
(ops/rasterizer.render_xyz). Each launch's depth and XYZ come to the host in
one copy, and the crops are cut there. It runs on `--device`, the card
unless `--device cpu`.

Usage:
  python -m gdrnet_tpu_torch.tools.gen_xyz --dataset lm --split test \
      --data-root datasets/BOP_DATASETS [--scenes 1 2] [--overwrite] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from gdrnet_tpu_torch.data import ref_meta
from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.rasterizer import render_xyz, render_xyz_roi_many, xyz_crop_from_render
from gdrnet_tpu_torch.tools import entry_device

TILES = (128, 256)


def _crop_info(depth: np.ndarray, xyz: np.ndarray, origin=(0, 0)) -> dict:
    """xyz_crop_from_render of a window, with xyxy in frame pixels."""
    info = xyz_crop_from_render(depth, xyz)
    if info["xyz_crop"].size:  # an empty render keeps the (0, 0, 0, 0) marker
        ox, oy = origin
        x1, y1, x2, y2 = info["xyxy"]
        info["xyxy"] = (x1 + ox, y1 + oy, x2 + ox, y2 + oy)
    return info


def _dump(path: str, info: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(info, f)


def gen_split_xyz(meta, split: str, scenes: list[int] | None = None, overwrite: bool = False,
                  chunk: int = 2048, device="cuda") -> int:
    """Write the missing (or, with overwrite, every) xyz_crop pickle of the
    split's scenes; returns how many were written. `chunk` is the JAX
    package's face-chunk size and is not used."""
    del chunk
    device = torch.device(device)
    split_dir = osp.join(meta.data_root, split)
    if scenes is None:
        scenes = sorted(int(d) for d in os.listdir(split_dir)
                        if d.isdigit() and osp.isdir(osp.join(split_dir, d)))
    meshes: dict = {}
    n_done, render_s = 0, 0.0
    for scene_id in scenes:
        scene_dir = osp.join(split_dir, f"{scene_id:06d}")
        with open(osp.join(scene_dir, "scene_gt.json")) as f:
            gt = json.load(f)
        with open(osp.join(scene_dir, "scene_camera.json")) as f:
            cams = json.load(f)
        out_dir = osp.join(scene_dir, "xyz_crop")
        os.makedirs(out_dir, exist_ok=True)

        pending: dict[int, list] = {}  # obj_id -> [(out_path, K, R, t)]
        for im_id_s, insts in sorted(gt.items(), key=lambda kv: int(kv[0])):
            im_id = int(im_id_s)
            K = np.asarray(cams[im_id_s]["cam_K"], np.float32).reshape(3, 3)
            for inst_i, inst in enumerate(insts):
                out_path = osp.join(out_dir, f"{im_id:06d}_{inst_i:06d}.pkl")
                if osp.exists(out_path) and not overwrite:
                    continue
                R = np.asarray(inst["cam_R_m2c"], np.float32).reshape(3, 3)
                t = np.asarray(inst["cam_t_m2c"], np.float32) / 1000.0
                pending.setdefault(int(inst["obj_id"]), []).append((out_path, K, R, t))

        for obj_id, items in pending.items():
            if obj_id not in meshes:
                ply = load_ply(meta.model_path(obj_id), vertex_scale=meta.vertex_scale)
                meshes[obj_id] = (ply["pts"], ply["faces"])
            verts, faces = meshes[obj_id]
            remaining = list(range(len(items)))
            for tile in TILES:
                if not remaining or tile > min(meta.height, meta.width):
                    continue
                t0 = time.perf_counter()
                outs, fitted = render_xyz_roi_many(
                    verts, faces, np.stack([items[i][1] for i in remaining]),
                    np.stack([items[i][2] for i in remaining]),
                    np.stack([items[i][3] for i in remaining]), meta.height, meta.width,
                    tile=tile, on_misfit="skip", device=device)
                if outs:  # one copy of the launch's windows to the host
                    depth = torch.stack([o[0] for o in outs]).cpu().numpy()
                    xyz = torch.stack([o[1] for o in outs]).cpu().numpy()
                render_s += time.perf_counter() - t0
                for k, ((_, _, origin), f) in enumerate(zip(outs, fitted)):
                    _dump(items[remaining[f]][0], _crop_info(depth[k], xyz[k], origin))
                    n_done += 1
                done = {remaining[f] for f in fitted}
                remaining = [i for i in remaining if i not in done]
            for i in remaining:  # projections larger than every tile: the full frame
                out_path, K, R, t = items[i]
                t0 = time.perf_counter()
                depth, xyz = (a.cpu().numpy() for a in render_xyz(
                    verts, faces, K, R, t, meta.height, meta.width, device=device))
                render_s += time.perf_counter() - t0
                _dump(out_path, _crop_info(depth, xyz))
                n_done += 1
        print(f"scene {scene_id}: done ({n_done} crops so far; renders with their copy "
              f"{render_s:.3f} s)", flush=True)
    return n_done


def main(argv=None, device="cuda") -> int:
    """Returns the number of crops written; `device` unless --device names one."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True,
                   help="a directory <data-root>/<name> with meta.json, or lm / lmo / ycbv")
    p.add_argument("--split", default="test")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--scenes", type=int, nargs="*", default=None)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--chunk", type=int, default=2048,
                   help="accepted for the JAX tool's command line and ignored: the "
                        "z-buffer kernel needs no face chunks")
    p.add_argument("--device", default=None,
                   help="where the renders run: cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = entry_device("gen_xyz", args.device or device)
    meta = ref_meta.meta_by_name(args.dataset, args.data_root)
    before = kernels.rasterize_attr.launches
    n = gen_split_xyz(meta, args.split, args.scenes, args.overwrite, args.chunk, device)
    print(f"generated {n} xyz crops; B2 launches {kernels.rasterize_attr.launches - before}",
          flush=True)
    return n


if __name__ == "__main__":
    main()
