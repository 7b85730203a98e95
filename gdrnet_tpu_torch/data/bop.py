"""BOP scene parsing -> flat per-instance records, and test detections (a
copy of gdrnet_tpu/data/bop.py:load_bop_scene_dicts and load_detections,
which cannot be imported without JAX).

Covers the reference's dataset modules (core/gdrn_modeling/datasets/
lm_dataset_d2.py:95-260, lm_pbr.py:120-260, ycbv_pbr.py, ycbv_d2.py): walk
scenes, join scene_gt / scene_gt_info / scene_camera json per image, and emit
one dict per *instance* (the reference flattens per-instance too,
dataset_utils.flat_dataset_dicts:27). Records are md5-keyed pickle-cached
like the reference (:80-93).

Record schema (all poses in metres, camera-frame):
  {scene_id, im_id, rgb_path, K [3,3], obj_id, label (name), R [3,3], t [3],
   bbox_visib xywh, bbox_obj xywh, visib_fract, mask_path, mask_visib_path,
   xyz_path (optional), depth_path + depth_scale (optional, when the scene
   has depth/ pngs — needed for vsd scoring), img_type}
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import pickle

import numpy as np

from gdrnet_tpu_torch.data.ref_meta import DatasetMeta


def _scene_json(scene_dir: str, name: str) -> dict:
    with open(osp.join(scene_dir, name)) as f:
        return json.load(f)


def _find_rgb(scene_dir: str, im_id: int) -> str:
    for sub, ext in (("rgb", "png"), ("rgb", "jpg"), ("gray", "tif")):
        p = osp.join(scene_dir, sub, f"{im_id:06d}.{ext}")
        if osp.exists(p):
            return p
    raise FileNotFoundError(f"no rgb for im {im_id} in {scene_dir}")


def load_bop_scene_dicts(
    meta: DatasetMeta,
    split_dir: str,
    scenes: list[int] | None = None,
    objs: list[str] | None = None,
    visib_thr: float = 0.0,
    img_type: str = "real",
    with_masks: bool = True,
    with_xyz: bool = True,
    cache_dir: str | None = None,
    im_ids: dict[int, set[int]] | None = None,
) -> list[dict]:
    """split_dir: e.g. <data_root>/test or <data_root>/train_pbr.
    objs: restrict to these object names (reference SELECTED_OBJS / per-object
    SO splits, lm_dataset_d2.py:56). im_ids: optional {scene_id: {im_id,...}}
    filter — the reference's image_set/<obj>_<split>.txt idx-file splits
    (lm_dataset_d2.py:103-107 reads `indices` from ann_files)."""
    split_path = osp.join(meta.data_root, split_dir) if not osp.isabs(split_dir) else split_dir
    if scenes is None:
        scenes = sorted(
            int(d) for d in os.listdir(split_path)
            if d.isdigit() and osp.isdir(osp.join(split_path, d)))
    sel_objs = set(objs if objs is not None else meta.objects)
    sel_ids = {meta.obj2id[o] for o in sel_objs if o in meta.obj2id}

    cache_key = hashlib.md5(
        json.dumps([meta.name, split_path, scenes, sorted(sel_objs), visib_thr,
                    img_type, with_masks, with_xyz, "v2-depth",
                    None if im_ids is None else
                    {str(k): sorted(v) for k, v in im_ids.items()}]
                   ).encode()).hexdigest()
    if cache_dir:
        cache_path = osp.join(cache_dir, f"bop_dicts_{meta.name}_{cache_key}.pkl")
        if osp.exists(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)

    records: list[dict] = []
    for scene_id in scenes:
        scene_dir = osp.join(split_path, f"{scene_id:06d}")
        gt = _scene_json(scene_dir, "scene_gt.json")
        gt_info = _scene_json(scene_dir, "scene_gt_info.json")
        cams = _scene_json(scene_dir, "scene_camera.json")
        has_depth = osp.isdir(osp.join(scene_dir, "depth"))
        allowed = None if im_ids is None else im_ids.get(scene_id, set())
        for im_id_s, insts in gt.items():
            im_id = int(im_id_s)
            if allowed is not None and im_id not in allowed:
                continue
            K = np.asarray(cams[im_id_s]["cam_K"], np.float32).reshape(3, 3)
            rgb_path = _find_rgb(scene_dir, im_id)
            # test-scene depth feeds vsd scoring (reference loads it via
            # inout.load_depth, lib/pysixd/inout.py:191-203; vsd's d_test in
            # lib/pysixd/pose_error.py:22-129)
            depth_path = (osp.join(scene_dir, "depth", f"{im_id:06d}.png")
                          if has_depth else None)
            depth_scale = float(cams[im_id_s].get("depth_scale", 1.0))
            infos = gt_info[im_id_s]
            for inst_i, inst in enumerate(insts):
                obj_id = int(inst["obj_id"])
                if obj_id not in sel_ids:
                    continue
                info = infos[inst_i]
                visib = float(info.get("visib_fract", 1.0))
                if visib <= visib_thr:
                    continue
                bbox_visib = np.asarray(info["bbox_visib"], np.float32)
                if bbox_visib[2] < 1 or bbox_visib[3] < 1:
                    continue
                R = np.asarray(inst["cam_R_m2c"], np.float32).reshape(3, 3)
                t = np.asarray(inst["cam_t_m2c"], np.float32) / 1000.0
                rec = {
                    "scene_id": scene_id,
                    "im_id": im_id,
                    "rgb_path": rgb_path,
                    "K": K,
                    "obj_id": obj_id,
                    "label": meta.id2obj[obj_id],
                    "R": R,
                    "t": t,
                    "bbox_visib": bbox_visib,
                    "bbox_obj": np.asarray(info.get("bbox_obj", info["bbox_visib"]), np.float32),
                    "visib_fract": visib,
                    "img_type": img_type,
                    "inst_i": inst_i,
                }
                if depth_path is not None and osp.exists(depth_path):
                    rec["depth_path"] = depth_path
                    rec["depth_scale"] = depth_scale
                if with_masks:
                    rec["mask_path"] = osp.join(scene_dir, "mask", f"{im_id:06d}_{inst_i:06d}.png")
                    rec["mask_visib_path"] = osp.join(
                        scene_dir, "mask_visib", f"{im_id:06d}_{inst_i:06d}.png")
                if with_xyz:
                    xyz_p = osp.join(scene_dir, "xyz_crop", f"{im_id:06d}_{inst_i:06d}.pkl")
                    if not osp.exists(xyz_p):
                        # reference artifact layout: <split>/xyz_crop/<scene>/
                        # <im>_<inst>-xyz.pkl (lm_pbr.py:41,166)
                        ref_p = osp.join(split_path, "xyz_crop", f"{scene_id:06d}",
                                         f"{im_id:06d}_{inst_i:06d}-xyz.pkl")
                        if osp.exists(ref_p):
                            xyz_p = ref_p
                    rec["xyz_path"] = xyz_p
                records.append(rec)

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(records, f)
    return records


def load_detections(det_json_path: str, score_thr: float = 0.0,
                    topk_per_obj: int = 1) -> dict:
    """Test detections json -> {(scene_id, im_id): [det...]} with per-object
    top-k / score filtering (reference load_detections_into_dataset,
    core/utils/dataset_utils.py:116-180). Each det: {obj_id, bbox xywh or
    bbox_est, score, time}. The json is either {"scene_id/im_id": [det...]}
    or a list of dets that carry scene_id and im_id (or image_id)."""
    with open(det_json_path) as f:
        dets = json.load(f)
    out: dict = {}
    if isinstance(dets, dict):
        # format {scene_im_id: [ {obj_id, bbox_est, score}, ...]}
        items = []
        for key, lst in dets.items():
            sid, iid = key.split("/")
            for d in lst:
                d = dict(d)
                d["scene_id"], d["im_id"] = int(sid), int(iid)
                items.append(d)
    else:
        items = dets
    by_img: dict = {}
    for d in items:
        key = (int(d["scene_id"]), int(d.get("im_id", d.get("image_id"))))
        if float(d.get("score", 1.0)) < score_thr:
            continue
        by_img.setdefault(key, []).append(d)
    for key, lst in by_img.items():
        per_obj: dict = {}
        for d in sorted(lst, key=lambda x: -float(x.get("score", 1.0))):
            per_obj.setdefault(int(d["obj_id"]), [])
            if len(per_obj[int(d["obj_id"])]) < topk_per_obj:
                per_obj[int(d["obj_id"])].append(d)
        out[key] = [d for ds in per_obj.values() for d in ds]
    return out
