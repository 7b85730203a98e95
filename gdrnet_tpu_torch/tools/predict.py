"""Pose prediction from images and detections to a BOP pose CSV, no GT
needed (counterpart of tools/predict.py:28-157): the serving entry point.

Any BOP-layout folder of PNG images, a detections JSON (BOP form:
{"scene/im": [{obj_id, bbox_est xywh, score}]} or a list of rows) and the
camera intrinsics give one pose a detection. The detections are mapped by
data/mapper.GDRNTestMapper into buckets of TEST.ROI_BATCH_SIZE crops; each
bucket is one forward of engine/steps.make_predict_step on `--device`, the
card unless `--device cpu`. TEST.FOLD_BN=True folds the BN statistics into
the convs first (utils/fold_bn.py), TEST.INT8=True calibrates on the first
bucket and serves int8 (models/quantize.py); TEST.USE_PNP=True refines
each bucket's poses from its decoded maps in TEST.PNP_TYPE's mode, on the
device with TEST.DEVICE_PNP=True, else per ROI on the host
(engine/pnp_refine.py); all are KEY=value options. Each CSV row's `time` is
its bucket's seconds (mapping, forward and refinement).

A frame is `<scene>/rgb/<im>.png`, else `.jpg` (data/jpeg.py decodes it).

TEST.LOCAL_DEVICES=n (-1, the default, for every visible card) splits each
bucket over replicas of the model on that many local cards, the largest
divisor of TEST.ROI_BATCH_SIZE no greater than n, as JAX's predict does
(tools/predict.py:79-86); the fold and int8 apply to every replica.

Usage:
  python -m gdrnet_tpu_torch.tools.predict --config-file configs/gdrn/lm/a6_cPnP_lm13.py \
      --ckpt output/.../ckpt --dataset lm --dets dets.json \
      --image-root datasets/BOP_DATASETS/lm/test --out poses.csv \
      [--camera-json <scene_camera.json>] [--K fx,fy,cx,cy] [--device cpu] \
      [TEST.FOLD_BN=True TEST.INT8=True] [TEST.USE_PNP=True TEST.PNP_TYPE=ransac_pnp
      TEST.DEVICE_PNP=True] [TEST.LOCAL_DEVICES=2]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import time

import numpy as np
import torch

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, apply_opts, merge_dict
from gdrnet_tpu_torch.data import ref_meta
from gdrnet_tpu_torch.data.bop import load_detections
from gdrnet_tpu_torch.data.io import load_json
from gdrnet_tpu_torch.data.mapper import GDRNTestMapper
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.engine.checkpoint import load_weights
from gdrnet_tpu_torch.engine.pnp_refine import refine_bucket_poses
from gdrnet_tpu_torch.engine.tester import _to_device, bucket_predictor
from gdrnet_tpu_torch.eval.bop_writer import save_bop_results
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.tools import entry_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--ckpt", required=True,
                   help="a checkpoint directory of the port, or a reference-layout .pth")
    p.add_argument("--dataset", required=True,
                   help="dataset for the object metadata: a directory <data-root>/<name> "
                        "with meta.json, or lm / lmo / ycbv")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--dets", required=True, help="detections json")
    p.add_argument("--image-root", required=True,
                   help="BOP split dir: <root>/<scene:06d>/rgb/<im:06d>.png (or .jpg)")
    p.add_argument("--camera-json", default=None,
                   help="per-image K; each scene's scene_camera.json under image-root "
                        "when omitted")
    p.add_argument("--K", default=None, help="global 'fx,fy,cx,cy' override")
    p.add_argument("--out", required=True, help="output BOP CSV path")
    p.add_argument("--device", default=None,
                   help="where the forward runs: cuda (the default) or cpu")
    p.add_argument("opts", nargs="*", default=[], help="KEY.PATH=value overrides")
    return p.parse_args(argv)


def _rgb_path(image_root: str, scene_id: int, im_id: int) -> str:
    """The frame's .png, else its .jpg (a BOP PBR split's frames)."""
    path = osp.join(image_root, f"{scene_id:06d}", "rgb", f"{im_id:06d}.png")
    return path if osp.exists(path) else path[:-4] + ".jpg"


def main(argv=None, device="cuda") -> list[dict]:
    """Writes the CSV and returns its rows; `device` unless --device names one."""
    args = parse_args(argv)
    device = entry_device("predict", args.device or device)
    cfg = Config(merge_dict(base_config().to_dict(), load_config(args.config_file).to_dict()))
    if args.opts:
        apply_opts(cfg, args.opts)

    meta = ref_meta.meta_by_name(args.dataset, args.data_root)
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    model = load_weights(build_model(cfg, device=device), args.ckpt)
    use_pnp = bool(cfg.TEST.USE_PNP)
    bucket = int(cfg.TEST.ROI_BATCH_SIZE)
    predict = bucket_predictor(cfg, model, bucket, with_maps=use_pnp)

    K_global = None
    if args.K:
        fx, fy, cx, cy = (float(v) for v in args.K.split(","))
        K_global = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    cams: dict = {}

    def K_of(scene_id: int, im_id: int) -> np.ndarray:
        if K_global is not None:
            return K_global
        path = args.camera_json or osp.join(args.image_root, f"{scene_id:06d}",
                                            "scene_camera.json")
        if path not in cams:
            cams[path] = load_json(path)
        return np.asarray(cams[path][str(im_id)]["cam_K"], np.float32).reshape(3, 3)

    dets = load_detections(args.dets, score_thr=0.0, topk_per_obj=100)
    mapper = GDRNTestMapper(cfg, models, roi_batch_size=bucket)
    flat = []
    for (scene_id, im_id), rois in sorted(dets.items()):
        rgb, K = _rgb_path(args.image_root, scene_id, im_id), K_of(scene_id, im_id)
        for d in rois:
            flat.append((rgb, K, dict(d, bbox=d.get("bbox_est", d.get("bbox")),
                                      bbox_mode="xywh"), scene_id, im_id))

    rows = []
    for start in range(0, len(flat), bucket):
        chunk = flat[start:start + bucket]
        t0 = time.perf_counter()
        batch = mapper.map_flat([(p, K, d) for p, K, d, _, _ in chunk])
        dev_batch = _to_device(batch, device)
        out = predict(dev_batch)
        if use_pnp:
            rot, trans = refine_bucket_poses(cfg, models, batch, dev_batch, out, seed=start)
        else:
            rot = out["rot"].float().cpu().numpy()  # waits for the bucket
            trans = out["trans"].float().cpu().numpy()
        dt = time.perf_counter() - t0
        for j, (_, _, _, scene_id, im_id) in enumerate(chunk):
            rows.append({"scene_id": scene_id, "im_id": im_id,
                         "obj_id": int(batch["obj_ids"][j]),
                         "score": float(batch["scores"][j]),
                         "R": rot[j], "t": trans[j] * 1000.0, "time": dt})

    save_bop_results(args.out, rows)
    print(json.dumps({"n_poses": len(rows), "csv": args.out}), flush=True)
    return rows


if __name__ == "__main__":
    main()
