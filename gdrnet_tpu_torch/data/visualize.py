"""Dataset visual inspection CLI (counterpart of gdrnet_tpu/data/visualize.py):
the reference's per-dataset `test_vis()` mains (e.g. lm_pbr.py:422-528:
load dicts, draw masks / bboxes / projected 3D boxes / xyz overlays through
grid_show for human inspection).

With --mapped it runs the train mapper, which renders the XYZ ground truth
of a record without an XYZ pickle on the mapper's device: on the card, the
z-buffer kernel (csrc/rasterize_xyz.cu). The panels are written by
utils/vis.grid_show: matplotlib's figure where it imports, else the mosaic.

Usage:
  python -m gdrnet_tpu_torch.data.visualize lm_13_test --data-root ... --n 4 \\
      --save-dir <dir>
  python -m gdrnet_tpu_torch.data.visualize lm_13_train --mapped  # mapper outputs
  ... --device cpu   # without a card (the default is the card)
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import tempfile

import numpy as np
import torch

from gdrnet_tpu_torch.data.io import read_image
from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper
from gdrnet_tpu_torch.ops.pose import project_points
from gdrnet_tpu_torch.tools import entry_device
from gdrnet_tpu_torch.utils import vis


def vis_records(meta, records, models, n: int = 4, save_dir: str | None = None,
                mapped: bool = False, cfg=None, seed: int = 0,
                device="cuda") -> list[str]:
    """Writes one panel file per record of the first n (rec_<i>.png, or
    mapped_<i>.png with `mapped`) under save_dir and returns their paths;
    `device` is where the mapper renders a missing XYZ ground truth."""
    device = entry_device("data.visualize", device)
    saved = []
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    if mapped:
        mapper = GDRNTrainMapper(cfg, models, device=device)
        for i, rec in enumerate(records[:n]):
            s = mapper(rec, rng)
            img = (s["roi_img"] * 255).clip(0, 255).astype(np.uint8)
            panels = [img, vis.vis_xyz_map(s["gt_xyz"]),
                      s["gt_mask_visib"], s["gt_region"] / max(s["gt_region"].max(), 1)]
            path = osp.join(save_dir, f"mapped_{i}.png") if save_dir else None
            vis.grid_show(panels, ["roi_img", "xyz", "mask_visib", "region"],
                          row=1, save_path=path)
            if path:
                saved.append(path)
        return saved

    for i, rec in enumerate(records[:n]):
        img = read_image(rec["rgb_path"])
        x, y, w, h = rec["bbox_visib"]
        panel = vis.vis_image_bboxes_cv2(img, [[x, y, x + w, y + h]], [rec["label"]])
        if rec.get("mask_visib_path") and osp.exists(rec["mask_visib_path"]):
            m = read_image(rec["mask_visib_path"], "gray")
            panel = vis.vis_image_mask_cv2(panel, m > 0, color_idx=2)
        corners3d = models.bbox3d[rec["label"]][:8]
        f32 = [torch.as_tensor(np.asarray(a, np.float32)[None])
               for a in (corners3d, rec["K"], rec["R"], rec["t"])]
        corners2d = project_points(*f32)[0].numpy()
        panel = vis.draw_projected_box3d(panel, corners2d)
        path = osp.join(save_dir, f"rec_{i}.png") if save_dir else None
        vis.grid_show([panel], [f"{rec['label']} s{rec['scene_id']} i{rec['im_id']}"],
                      save_path=path)
        if path:
            saved.append(path)
    return saved


def main(argv=None, device="cuda") -> list[str]:
    """Prints how many panels it wrote, where, and with which grid backend;
    returns their paths. `device` unless --device names one."""
    p = argparse.ArgumentParser()
    p.add_argument("dataset")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--save-dir", default=osp.join(tempfile.gettempdir(), "gdrnet_vis"))
    p.add_argument("--mapped", action="store_true",
                   help="visualize mapper outputs (ROI crops + targets)")
    p.add_argument("--device", default=None,
                   help="where the mapper renders XYZ: cuda (the default) or cpu")
    args = p.parse_args(argv)

    from gdrnet_tpu_torch.config import base_config
    from gdrnet_tpu_torch.data.dataset_factory import resolve
    from gdrnet_tpu_torch.data.model_store import ObjectModels

    meta, records = resolve(args.dataset, args.data_root)
    models = ObjectModels(meta, num_pm_points=512)
    cfg = base_config()
    saved = vis_records(meta, records, models, n=args.n, save_dir=args.save_dir,
                        mapped=args.mapped, cfg=cfg, device=args.device or device)
    print(f"saved {len(saved)} panels to {args.save_dir} (grid: {vis.grid_backend()})")
    return saved


if __name__ == "__main__":
    main()
