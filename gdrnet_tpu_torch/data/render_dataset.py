"""Per-object rendered-folder datasets (blender / DeepIM-imgn synthetic sets;
counterpart of gdrnet_tpu/data/render_dataset.py).

The reference's lm_blender.py / lm_syn_imgn.py layout: one folder per object
under `renders/<obj>/` with `{i}.jpg`, `{i}_mask_opengl.png`,
`{i}_depth_opengl.png`, `{i}_xyz_bop.pkl`, plus a `<obj>_gt.json` mapping
im_id -> [{cam_R_m2c, cam_t_m2c (mm), bbox_visib, visib_fract?}] (one
instance per image). Emits the same per-instance record schema as
bop.load_bop_scene_dicts so the train mapper consumes both; img_type
"syn_blender"/"syn" triggers background replacement. The `{i}.jpg` frames
are read by data/jpeg.py.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from gdrnet_tpu_torch.data.ref_meta import DatasetMeta


def load_render_folder_dicts(
    meta: DatasetMeta,
    renders_root: str,
    objs: list[str] | None = None,
    n_per_obj: int = -1,
    img_type: str = "syn_blender",
    img_ext: str = "jpg",
    mask_suffix: str = "_mask_opengl.png",
    xyz_suffix: str = "_xyz_bop.pkl",
    visib_thr: float = 0.0,
) -> list[dict]:
    """renders_root: e.g. <data>/lm_renders_blender/renders. n_per_obj
    samples uniformly (equal spacing, reference lm_blender.py:116-123)."""
    records: list[dict] = []
    for obj_name in (objs if objs is not None else meta.objects):
        ann_file = osp.join(renders_root, f"{obj_name}_gt.json")
        scene_root = osp.join(renders_root, obj_name)
        if not osp.exists(ann_file):
            continue
        with open(ann_file) as f:
            gt = json.load(f)
        keys = list(gt.keys())
        if n_per_obj > 0:
            sel = np.linspace(0, len(keys) - 1, min(n_per_obj, len(keys)),
                              dtype=np.int64)
            keys = [keys[int(i)] for i in sel]
        obj_id = meta.obj2id[obj_name]
        for str_im_id in keys:
            anno = gt[str_im_id][0]  # one instance per render
            visib = float(anno.get("visib_fract", 1.0))
            if visib <= visib_thr:
                continue
            bbox = np.asarray(anno["bbox_visib"], np.float32)
            if bbox[2] <= 1 or bbox[3] <= 1:
                continue
            rgb_path = osp.join(scene_root, f"{str_im_id}.{img_ext}")
            records.append({
                "scene_id": obj_id,  # scene == object for these sets
                "im_id": int(str_im_id),
                "rgb_path": rgb_path,
                "K": np.asarray(meta.camera_matrix, np.float32),
                "obj_id": obj_id,
                "label": obj_name,
                "R": np.asarray(anno["cam_R_m2c"], np.float32).reshape(3, 3),
                "t": np.asarray(anno["cam_t_m2c"], np.float32).reshape(3) / 1000.0,
                "bbox_visib": bbox,
                "bbox_obj": bbox,
                "visib_fract": visib,
                "img_type": img_type,
                "inst_i": 0,
                "mask_path": osp.join(scene_root, f"{str_im_id}{mask_suffix}"),
                "mask_visib_path": osp.join(scene_root, f"{str_im_id}{mask_suffix}"),
                "xyz_path": osp.join(scene_root, f"{str_im_id}{xyz_suffix}"),
            })
    return records
