"""Compute FPS keypoints for every object model of a BOP dataset (counterpart
of tools/compute_fps.py, on the port's PLY reader and ops/fps).

Output: <models_dir>/fps_points.pkl keyed by str(obj_id), each entry holding
fps{4,8,12,16,20,32,64,128,256}_and_center float32 arrays (the K samples,
then the mean of the vertices) for every K up to the model's vertex count:
the artifact the reference produces (tools/lm/1_compute_fps.py:18-38) and
the data layer's DatasetMeta.fps_points() loads.

The samples run on `--device`: on the card (the default) through the
device FPS (ops/fps.farthest_point_sampling), with --device cpu through the
port's C++ twin (csrc/fps.cpp, built with g++ at first use). Both give
farthest_point_sampling_np's points bit for bit, so the file is the same
either way. Neither falls back: without a card --device cuda raises, and
without g++ --device cpu raises with the build's message.

Usage:
  python -m gdrnet_tpu_torch.tools.compute_fps --dataset lm --data-root datasets/BOP_DATASETS
  python -m gdrnet_tpu_torch.tools.compute_fps --models-dir path/to/models [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import pickle
from typing import Callable

import numpy as np

from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.data.ref_meta import get_meta
from gdrnet_tpu_torch.ops import fps
from gdrnet_tpu_torch.tools import entry_device

FPS_COUNTS = (4, 8, 12, 16, 20, 32, 64, 128, 256)


def device_sampler(device) -> Callable:
    """The device FPS on `device` as a host sampler: (pts, k, init_center) ->
    float32 [k, 3] numpy points."""
    def sample(pts, k, init_center=True):
        return fps.farthest_point_sampling(pts, k, init_center, device=device).cpu().numpy()

    return sample


def compute_fps_dict(models_dir: str, obj_ids: list[int], vertex_scale: float = 0.001,
                     sampler: Callable = fps.farthest_point_sampling_np) -> dict:
    """{str(obj_id): {f"fps{K}_and_center": [K + 1, 3] float32}}.
    `sampler(pts, k, init_center)` returns [k, 3] points; it runs once a
    model, at the model's largest K: the greedy order does not depend on K,
    so each smaller K's samples are the first K of those."""
    fps_dict: dict = {}
    for obj_id in obj_ids:
        ply = load_ply(osp.join(models_dir, f"obj_{obj_id:06d}.ply"), vertex_scale=vertex_scale)
        pts = ply["pts"]
        center = pts.mean(0, keepdims=True).astype(np.float32)
        counts = [k for k in FPS_COUNTS if k <= len(pts)]
        samples = np.asarray(sampler(pts, counts[-1], True), np.float32) if counts else None
        entry = {f"fps{k}_and_center": np.concatenate([samples[:k], center], 0)
                 for k in counts}
        fps_dict[str(obj_id)] = entry
        print(f"obj {obj_id}: {len(pts)} verts -> fps keys {sorted(entry)}")
    return fps_dict


def main(argv=None, device="cuda") -> str:
    """Writes <models_dir>/fps_points.pkl and returns its path; runs on
    `device` unless --device names one."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default=None, help="lm | lmo | ycbv")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--models-dir", default=None)
    p.add_argument("--vertex-scale", type=float, default=0.001)
    p.add_argument("--device", default=None,
                   help="where the samples run: cuda (the default, the device FPS) or cpu "
                        "(the C++ twin)")
    args = p.parse_args(argv)
    if not (args.models_dir or args.dataset):
        p.error("give --dataset or --models-dir")
    device = entry_device("compute_fps", args.device or device)

    if args.models_dir:
        models_dir = args.models_dir
        with open(osp.join(models_dir, "models_info.json")) as f:
            obj_ids = sorted(int(k) for k in json.load(f))
    else:
        meta = get_meta(args.dataset, args.data_root)
        models_dir = meta.model_dir
        obj_ids = sorted(meta.id2obj)

    sampler = fps.farthest_point_sampling_cpp if device.type == "cpu" else device_sampler(device)
    fps_dict = compute_fps_dict(models_dir, obj_ids, args.vertex_scale, sampler)
    out = osp.join(models_dir, "fps_points.pkl")
    with open(out, "wb") as f:
        pickle.dump(fps_dict, f)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
