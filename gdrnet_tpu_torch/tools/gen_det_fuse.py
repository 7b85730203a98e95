"""Synthesize a COCO-style detection training set by pasting object crops
onto background images (counterpart of the repository's
tools/gen_det_fuse.py; the reference's detection-fusion tool
tools/lmo/1_gen_det_lm_real_all_fuse.py:1-183): the masked pixels of
objects of a source split are composited onto random backgrounds at random
positions and scales, and written as JPEG images with a COCO json (bbox
xywh, category_id = obj_id) to train a 2D detector.

Without cv2: frames and masks are read by data/io (PNG, or JPEG through
data/jpeg.py), the crops resized by data/cv_ops.resize_linear and the masks
by resize_nearest, and the images written by data/jpeg.py's encoder at
cv2.imwrite's default quality 95, each bitwise equal to the cv2 call it
stands for; the backgrounds come from data/augment.BackgroundReplacer. The
draws of np.random.RandomState(seed) come in the JAX tool's order, so both
tools write the same files. Host only: no device is touched.

Usage:
  python -m gdrnet_tpu_torch.tools.gen_det_fuse --dataset lm --split test --num-images 100 \\
      --bg-root datasets/VOCdevkit/VOC2012 --out datasets/lm_det_fuse
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from gdrnet_tpu_torch.data.augment import BackgroundReplacer
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.cv_ops import resize_linear, resize_nearest
from gdrnet_tpu_torch.data.io import read_image
from gdrnet_tpu_torch.data.jpeg import write_jpeg
from gdrnet_tpu_torch.data.ref_meta import meta_by_name


def _imread(path: str, flags: str) -> np.ndarray | None:
    """cv2.imread(path, IMREAD_COLOR or IMREAD_GRAYSCALE): None where cv2
    gives None (no path, a missing, unreadable or corrupt file)."""
    try:
        return read_image(path, flags)
    except (OSError, ValueError):
        return None


def fuse_images(records: list[dict], out_dir: str, num_images: int,
                bg_replacer, objs_per_img: tuple[int, int] = (3, 8),
                wh: tuple[int, int] = (640, 480), seed: int = 0) -> dict:
    """Returns the COCO dict (also written to out_dir/annotations.json)."""
    rng = np.random.RandomState(seed)
    os.makedirs(osp.join(out_dir, "images"), exist_ok=True)
    W, H = wh
    images, annotations = [], []
    ann_id = 1
    cat_ids = sorted({r["obj_id"] for r in records})
    for img_id in range(num_images):
        canvas = bg_replacer.get_bg(rng, H, W).copy()
        n_obj = rng.randint(objs_per_img[0], objs_per_img[1] + 1)
        for _ in range(n_obj):
            rec = records[rng.randint(len(records))]
            src = _imread(rec["rgb_path"], "color")
            mask = _imread(rec.get("mask_visib_path", ""), "gray")
            if src is None or mask is None or mask.max() == 0:
                continue
            ys, xs = np.nonzero(mask)
            x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
            crop = src[y1:y2 + 1, x1:x2 + 1]
            crop_m = (mask[y1:y2 + 1, x1:x2 + 1] > 0)
            s = rng.uniform(0.6, 1.4)  # random rescale
            nw = max(int(crop.shape[1] * s), 4)
            nh = max(int(crop.shape[0] * s), 4)
            if nw >= W or nh >= H:
                continue
            crop = resize_linear(crop, nw, nh)
            crop_m = resize_nearest(crop_m.astype(np.uint8), nw, nh).astype(bool)
            px = rng.randint(0, W - nw)
            py = rng.randint(0, H - nh)
            region = canvas[py:py + nh, px:px + nw]
            region[crop_m] = crop[crop_m]
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": int(rec["obj_id"]),
                "bbox": [int(px), int(py), int(nw), int(nh)],
                "area": int(crop_m.sum()), "iscrowd": 0,
            })
            ann_id += 1
        fname = f"{img_id:06d}.jpg"
        write_jpeg(osp.join(out_dir, "images", fname), canvas, quality=95)
        images.append({"id": img_id, "file_name": f"images/{fname}", "width": W, "height": H})
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": cid, "name": str(cid)} for cid in cat_ids],
    }
    with open(osp.join(out_dir, "annotations.json"), "w") as f:
        json.dump(coco, f)
    return coco


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True,
                   help="a directory <data-root>/<name> with meta.json, or lm / lmo / ycbv")
    p.add_argument("--split", default="test")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--bg-root", default="")
    p.add_argument("--num-images", type=int, default=1000)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    meta = meta_by_name(args.dataset, args.data_root)
    records = load_bop_scene_dicts(meta, args.split, with_xyz=False)
    coco = fuse_images(records, args.out, args.num_images, BackgroundReplacer(args.bg_root),
                       wh=(meta.width, meta.height), seed=args.seed)
    print(f"wrote {len(coco['images'])} images, {len(coco['annotations'])} annotations to "
          f"{args.out}", flush=True)
    return coco


if __name__ == "__main__":
    main()
