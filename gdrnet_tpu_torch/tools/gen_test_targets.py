"""Generate a BOP test-targets json ({im_id, inst_count, obj_id, scene_id}
rows) from scene_gt files (counterpart of the repository's
tools/gen_test_targets.py; the reference's per-dataset generators
lib/pysixd/gen_ycbv_test_targets_keyframe_json.py:45-80 and its siblings as
one dataset-agnostic command). The json is byte for byte the JAX tool's.
Host only: json in, json out; no device is touched.

Usage:
  python -m gdrnet_tpu_torch.tools.gen_test_targets --dataset ycbv --split test \\
      [--keyframe datasets/BOP_DATASETS/ycbv/image_sets/keyframe.txt] \\
      --out test_targets_keyframe.json
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from collections import Counter

from gdrnet_tpu_torch.data.io import load_json
from gdrnet_tpu_torch.data.ref_meta import meta_by_name


def collect_targets(split_path: str, keyframes: set[str] | None = None) -> list[dict]:
    """The rows of every scene under `split_path`, by scene, image, object;
    with `keyframes` ('SSSS/IIIIII' strings) only those images."""
    scene_ids = sorted(int(d) for d in os.listdir(split_path)
                       if d.isdigit() and osp.isdir(osp.join(split_path, d)))
    targets = []
    for scene_id in scene_ids:
        gt = load_json(osp.join(split_path, f"{scene_id:06d}", "scene_gt.json"))
        for im_key in sorted(gt, key=int):
            im_id = int(im_key)
            if keyframes is not None and f"{scene_id:04d}/{im_id:06d}" not in keyframes:
                continue
            counts = Counter(int(a["obj_id"]) for a in gt[im_key])
            for obj_id, n in sorted(counts.items()):
                targets.append({"im_id": im_id, "inst_count": n, "obj_id": obj_id,
                                "scene_id": scene_id})
    return targets


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True,
                   help="a directory <data-root>/<name> with meta.json, or lm / lmo / ycbv")
    p.add_argument("--split", default="test")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--keyframe", default=None,
                   help="optional keyframe.txt ('SSSS/IIIIII' lines) filter")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    meta = meta_by_name(args.dataset, args.data_root)
    keyframes = None
    if args.keyframe:
        with open(args.keyframe) as f:
            keyframes = {line.strip() for line in f if line.strip()}
    targets = collect_targets(osp.join(meta.data_root, args.split), keyframes)
    with open(args.out, "w") as f:
        json.dump(targets, f, indent=1)
    print(f"wrote {len(targets)} targets -> {args.out}", flush=True)
    return targets


if __name__ == "__main__":
    main()
