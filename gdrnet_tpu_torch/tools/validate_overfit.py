"""Learning check on one card (the counterpart of tools/validate_overfit.py):
overfit a 2-object split with the full train step (Ranger and every loss of
GDR-Net), then score its poses with engine/tester.do_test; `--int8` scores
the int8 serving path (TEST.INT8) as well.

The split is the counterpart of tests/fixture_bop.py, which needs cv2: the
generator zoo's cube and brick (z-180 symmetric, DATASETS.SYM_OBJS), `--images`
frames of 2 instances at 320x240 written by data/synthetic.write_bop_split
(the depth, masks and xyz_crop pickles rendered on the z-buffer kernel of
the device), each frame then repainted as the fixture paints its own
(paint_like_fixture). Every record is mapped once by GDRNTrainMapper with
INPUT.DZI_TYPE "none", so that the train crops are the test crops; TOTAL
train steps on that one batch with the config of overfit_cfg; then do_test
on the same records with their GT boxes. `--seed` varies the model's init
and the train step's generator, the data stays fixed. The brick may
converge to either branch of its declared symmetry: the symmetric PM loss
permits both and the evaluator resolves them. `--device-preprocess` maps the
records with GDRNRawTrainMapper instead and makes the batch on the device
with data/device_pipeline.device_train_batch (DZI "none"), as the JAX
tool's flag does.

Prints a line every 200 steps, the train seconds, do_test's summary and one
line `SWEEP {"seed", "images", "device_preprocess", "ad_10", "mean_re",
"mean_te"}` (mean_re in degrees, mean_te in metres). `--save-ckpt DIR`
writes DIR/ckpt in the port's checkpoint format and DIR/config.py with the
model's dims, where tools/bench.py finds trained weights (DEFAULT_CKPTS).
The split and do_test's files go to a temporary directory.

Usage:
  python -m gdrnet_tpu_torch.tools.validate_overfit [--seed N] [--images 6] [--int8]
      [--device-preprocess] [--save-ckpt DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import pickle
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.io import read_png, write_png
from gdrnet_tpu_torch.data.device_augment import TorchKey
from gdrnet_tpu_torch.data.device_pipeline import device_train_batch
from gdrnet_tpu_torch.data.mapper import GDRNRawTrainMapper, GDRNTrainMapper, collate
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.tester import do_test
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule
from gdrnet_tpu_torch.tools import entry_device
from gdrnet_tpu_torch.tools.gen_scale_dataset import mesh_zoo

TOTAL = 800           # train steps
IMAGES = 6            # frames of the split, 2 instances each
PRINT_EVERY = 200
SPLIT_SEED = 42       # the split's poses, as the fixture's seed
K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
WIDTH, HEIGHT = 320, 240

# tools/bench.py reads these model dims beside the checkpoint
CONFIG_PY = """\
# written by gdrnet_tpu_torch.tools.validate_overfit --save-ckpt: the model
# dims of the saved checkpoint (for gdrnet_tpu_torch.tools.bench --ckpt).
MODEL = dict(CDPN=dict(
    BACKBONE=dict(NUM_LAYERS=18),
    ROT_HEAD=dict(NUM_CLASSES=2, NUM_REGIONS=8),
    PNP_NET=dict(WITH_2D_COORD=True, REGION_ATTENTION=True,
                 PM_LOSS_SYM=True, PM_NORM_BY_EXTENT=True,
                 CENTROID_LW=1.0, Z_LW=1.0),
))
"""


def overfit_cfg():
    """tools/validate_overfit.py:38-54's config on the port's defaults."""
    c = base_config()
    c.MODEL.CDPN.BACKBONE.NUM_LAYERS = 18
    c.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    c.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 8
    pnp = c.MODEL.CDPN.PNP_NET
    pnp.WITH_2D_COORD = pnp.REGION_ATTENTION = pnp.PM_LOSS_SYM = pnp.PM_NORM_BY_EXTENT = True
    pnp.CENTROID_LW = pnp.Z_LW = 1.0
    c.DATASETS.SYM_OBJS = ["brick"]
    c.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=0)
    c.SOLVER.ANNEAL_POINT = 0.72
    c.TEST.ROI_BATCH_SIZE = 4
    c.PARALLEL.DTYPE = "bfloat16"
    c.INPUT.DZI_TYPE = "none"  # train crops == test crops
    return c


def overfit_split(root: str, images: int = IMAGES, device="cuda"):
    """The counterpart of tests/fixture_bop.py at `root`: the zoo's cube and
    brick, `images` frames x 2 instances at 320x240 apart enough not to
    occlude each other, a test split with xyz_crop pickles, its frames
    painted as the fixture paints them. Returns its DatasetMeta."""
    rng = np.random.RandomState(SPLIT_SEED)
    n = 2 * images
    p = synthetic_roi_batch(batch_size=n, input_res=8, out_res=4, num_classes=2, seed=SPLIT_SEED)
    t = np.stack([np.array([rng.uniform(-0.025, 0.025) + (-0.085 if i % 2 == 0 else 0.085),
                            rng.uniform(-0.03, 0.03), rng.uniform(0.45, 0.7)])
                  for i in range(n)]).astype(np.float32)
    meta, _ = write_bop_split(root, mesh_zoo()[:2], np.arange(n) % 2, p["gt_ego_rot"], t, K,
                              width=WIDTH, height=HEIGHT, per_image=2, images_per_scene=images,
                              device=device, with_xyz_crop=True)
    paint_like_fixture(load_bop_scene_dicts(meta, "test"), HEIGHT, WIDTH)
    return meta


def paint_like_fixture(records, height: int, width: int, seed: int = 0) -> None:
    """Repaint each frame as tests/fixture_bop.py paints its own: a noise
    background (60 + U[0, 40) a channel), each instance's visible pixels
    shaded by their object-frame z (100 + 120 z / max z, in the fixture's
    channel mix), so that a frame shows the object's orientation and not
    only its silhouette (write_bop_split paints one flat colour an object,
    and a flat box leaves flips beyond its declared symmetry unseen)."""
    rng = np.random.RandomState(seed)
    by_frame: dict = defaultdict(list)
    for r in records:
        by_frame[r["rgb_path"]].append(r)
    for path, recs in by_frame.items():
        bgr = (60 + rng.rand(height, width, 3) * 40).astype(np.uint8)
        for r in recs:
            with open(r["xyz_path"], "rb") as f:
                crop = pickle.load(f)
            x1, y1, x2, y2 = crop["xyxy"]
            z = np.zeros((height, width), np.float32)
            z[y1:y2 + 1, x1:x2 + 1] = np.asarray(crop["xyz_crop"], np.float32)[..., 2]
            shade = 100 + 120 * (z / max(float(z.max()), 1e-6))
            color = np.stack([shade * 0.6, shade, shade * (0.4 + 0.3 * r["obj_id"])], axis=-1)
            visible = read_png(r["mask_visib_path"]) > 0
            bgr = np.where(visible[..., None], color.clip(0, 255).astype(np.uint8), bgr)
        write_png(path, np.ascontiguousarray(bgr[..., ::-1]))


def map_split(cfg, meta, device, device_preprocess: bool = False
              ) -> tuple[list, ObjectModels, dict]:
    """(records, object models, the batch of every record mapped once with
    RandomState(i) for record i, on `device`): by GDRNTrainMapper, or with
    device_preprocess by GDRNRawTrainMapper and then
    data/device_pipeline.device_train_batch on the device (DZI "none", the
    generator seeded 3), as the JAX tool's --device-preprocess."""
    records = load_bop_scene_dicts(meta, "test", img_type="real")
    models = ObjectModels(meta, num_pm_points=256, num_fps=8)
    device = torch.device(device)
    mapper_cls = GDRNRawTrainMapper if device_preprocess else GDRNTrainMapper
    mapper = mapper_cls(cfg, models, device=device)
    batch = collate([mapper(rec, np.random.RandomState(i)) for i, rec in enumerate(records)])
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if device_preprocess:
        stacks = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
            models.points_stack, models.extents_stack, models.fps_stack,
            models.sym_rots_stack, models.sym_mask_stack)]
        batch = device_train_batch(
            TorchKey(torch.Generator(device=device).manual_seed(3)), batch, *stacks,
            torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=device),
            torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=device),
            input_res=cfg.MODEL.CDPN.BACKBONE.INPUT_RES,
            out_res=cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES, dzi_type="none",
            pad_scale=cfg.INPUT.DZI_PAD_SCALE)
    return records, models, batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_seed(cfg, split: tuple, seed: int, out_dir: str, device, echo=print,
             init=init_weights) -> dict:
    """One seed of the check on map_split's `split`: the model initialised
    by `init(model, generator)` with the generator seeded `seed`
    (models/gdrn.init_weights by default; scripts/probe_torch_overfit.py
    compares another rule), TOTAL
    train steps on the batch with the train step's generator seeded
    `seed + 1`, then do_test on the records into `out_dir`. `echo` gets a
    line every PRINT_EVERY steps and the last. Returns {"model", "batch",
    "history" (each loss term and total_loss by step, numpy), "train_s",
    "state", "results"}."""
    records, models, batch = split
    device = torch.device(device)
    model = init(build_model(cfg, device=device), torch.Generator().manual_seed(seed))
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-3, TOTAL))
    state, step = create_train_state(model, opt), make_train_step(cfg, model, opt)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    _sync(device)
    t0 = time.perf_counter()
    history = []
    for it in range(TOTAL):
        metrics = step(state, batch, gen)[1]
        history.append({k: v for k, v in metrics.items()
                        if k.startswith("loss") or k == "total_loss"})
        if it % PRINT_EVERY == 0 or it == TOTAL - 1:
            parts = " ".join(f"{k.removeprefix('loss_')}={float(v):.3f}"
                             for k, v in sorted(metrics.items()) if k.startswith("loss"))
            echo(f"it {it}: total={float(metrics['total_loss']):.3f} "
                 f"errR={float(metrics['vis/error_R']):.1f}deg "
                 f"errT={float(metrics['vis/error_t']):.2f}cm | {parts}")
    _sync(device)
    train_s = time.perf_counter() - t0
    hist = {k: torch.stack([h[k] for h in history]).float().cpu().numpy() for k in history[0]}
    results = do_test(cfg, state.model, models, records, output_dir=out_dir, device=device)
    return {"model": state.model, "batch": batch, "history": hist, "train_s": train_s,
            "state": state, "results": results}


def save_checkpoint(state, arg: str) -> str:
    """state into <arg>/ckpt (or <arg> itself when it is named ckpt) and the
    model dims into config.py beside that directory, as the JAX tool lays
    them out; returns the checkpoint directory."""
    ckpt_dir = arg if osp.basename(arg.rstrip("/")) == "ckpt" else osp.join(arg, "ckpt")
    CheckpointManager(ckpt_dir).save(state)
    with open(osp.join(osp.dirname(osp.abspath(ckpt_dir)), "config.py"), "w") as f:
        f.write(CONFIG_PY)
    return ckpt_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="the model's init and the train step's generator; the data stays fixed")
    p.add_argument("--images", type=int, default=IMAGES,
                   help="frames of the split (2 ROIs each); 12 steadies ad_10 across seeds")
    p.add_argument("--int8", action="store_true", help="also score the int8 serving path")
    p.add_argument("--save-ckpt", default=None, help="write DIR/ckpt and DIR/config.py")
    p.add_argument("--device-preprocess", action="store_true",
                   help="map raw frames and make the batch on the device (device_train_batch)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Runs the check and returns the SWEEP dict; `device` unless --device
    names one."""
    args = parse_args(argv)
    device = entry_device("validate_overfit", args.device or device)
    cfg = overfit_cfg()
    with tempfile.TemporaryDirectory(prefix="validate_overfit_") as work:
        meta = overfit_split(osp.join(work, "split"), args.images, device=device)
        split = map_split(cfg, meta, device, args.device_preprocess)
        if args.device_preprocess:
            print("training through the device preprocessing pipeline", flush=True)
        run = run_seed(cfg, split, args.seed, osp.join(work, "out"), device,
                       echo=lambda line: print(line, flush=True))
        print(f"train time: {run['train_s']:.0f}s", flush=True)
        if args.save_ckpt:
            print("saved checkpoint to", save_checkpoint(run["state"], args.save_ckpt), flush=True)
        results = run["results"]
        print(results["_summary"], flush=True)
        avg = results["Avg"]
        print("ad_10 avg:", avg["ad_10"], " re mean:", avg["mean_re"], flush=True)
        sweep = {"seed": args.seed, "images": args.images,
                 "device_preprocess": args.device_preprocess,
                 "ad_10": float(avg["ad_10"]), "mean_re": float(avg["mean_re"]),
                 "mean_te": float(avg["mean_te"])}
        print("SWEEP " + json.dumps(sweep), flush=True)
        if args.int8:  # the quantized serving path's quality (TEST.INT8)
            cfg.TEST.INT8 = True
            records, models, _ = split
            r8 = do_test(cfg, run["model"], models, records, output_dir=osp.join(work, "out_int8"),
                         device=device)
            print("int8:", r8["_summary"], flush=True)
            print("int8 ad_10 avg:", r8["Avg"]["ad_10"], " re mean:", r8["Avg"]["mean_re"],
                  flush=True)
    return sweep


if __name__ == "__main__":
    main()
