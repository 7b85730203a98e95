"""FPS keypoints for every object model of a BOP models directory (a copy of
compute_fps_dict in tools/compute_fps.py, on the port's PLY reader and
ops/fps).

Output layout: fps_points.pkl keyed by str(obj_id), each entry holding
fps{4,8,12,16,20,32,64,128,256}_and_center arrays — the artifact the
reference produces (tools/lm/1_compute_fps.py:18-38) and the data layer's
DatasetMeta.fps_points() loads. The JAX package's tool samples with its C++
twin where a compiler is present; both follow farthest_point_sampling_np's
semantics.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.ops.fps import farthest_point_sampling_np

FPS_COUNTS = (4, 8, 12, 16, 20, 32, 64, 128, 256)


def compute_fps_dict(models_dir: str, obj_ids: list[int], vertex_scale: float = 0.001) -> dict:
    fps_dict: dict = {}
    for obj_id in obj_ids:
        ply = load_ply(osp.join(models_dir, f"obj_{obj_id:06d}.ply"), vertex_scale=vertex_scale)
        pts = ply["pts"]
        center = pts.mean(0, keepdims=True).astype(np.float32)
        entry = {}
        for k in FPS_COUNTS:
            if k > len(pts):
                continue
            fps_pts = np.asarray(farthest_point_sampling_np(pts, k, True), np.float32)
            entry[f"fps{k}_and_center"] = np.concatenate([fps_pts, center], 0)
        fps_dict[str(obj_id)] = entry
        print(f"obj {obj_id}: {len(pts)} verts -> fps keys {sorted(entry)}")
    return fps_dict
