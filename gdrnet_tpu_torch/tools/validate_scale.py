"""Held-out learning check on the generated synth dataset (the counterpart of
tools/validate_scale.py): train the flagship (configs/gdrn/synth/
a6_cPnP_synth.py: GDRN-R34, 10 objects, 4 of them symmetric) on a fixed
slice of the train images and score ad_10, re and te on a fixed slice of
the held-out test images, with their GT boxes.

Each held-out ROI is a fraction of a percent of the recall, where the
2-object check of tools/validate_overfit.py makes each ROI 8 %, so ad_10 is
a statistic here. Run it over several seeds and compare the SWEEP lines.
The slices are the same for every seed: each split's records (one per
instance visible above 10 %) sorted by (scene_id, im_id), then the first
--train-images train and --test-images test records. The flags count
records, not images, as the JAX tool's slices do.

Needs the dataset that gdrnet_tpu_torch.tools.gen_scale_dataset writes at
--root. Trains with engine/trainer.do_train (no checkpoints), tests with
engine/tester.do_test (VAL.ERROR_TYPES ad,rete,re,te,proj) into
--out_seed<N>, and prints do_test's summary and one line `SWEEP {"seed",
"train_images", "test_images", "epochs", "train_secs", "ad_10", "mean_re",
"mean_te"}`. It runs on the card unless --device cpu.

Usage:
  python -m gdrnet_tpu_torch.tools.validate_scale [--seed N] [--train-images 200]
      [--test-images 50] [--epochs 160] [--batch 128] [--out DIR]
      [--root datasets/BOP_DATASETS/synth] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, merge_dict
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.dataset_factory import register
from gdrnet_tpu_torch.data.ref_meta import meta_from_json
from gdrnet_tpu_torch.engine.tester import do_test
from gdrnet_tpu_torch.engine.trainer import do_train
from gdrnet_tpu_torch.tools import entry_device

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
CONFIG = osp.join(REPO, "configs", "gdrn", "synth", "a6_cPnP_synth.py")
TRAIN_NAME, TEST_NAME = "synthgate_train", "synthgate_test"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-images", type=int, default=200)
    p.add_argument("--test-images", type=int, default=50)
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--out", default=osp.join(tempfile.gettempdir(), "validate_scale"))
    p.add_argument("--root", default="datasets/BOP_DATASETS/synth")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def select_records(meta, train_images: int, test_images: int) -> tuple[list, list]:
    """The fixed slices: each split's records sorted by (scene_id, im_id),
    then the first N of them, as tools/validate_scale.py takes them."""
    train = load_bop_scene_dicts(meta, "train", visib_thr=0.1, img_type="syn_pbr")
    train.sort(key=lambda r: (r["scene_id"], r["im_id"]))
    test = load_bop_scene_dicts(meta, "test", visib_thr=0.1, img_type="real")
    test.sort(key=lambda r: (r["scene_id"], r["im_id"]))
    return train[:train_images], test[:test_images]


def build_config(args) -> Config:
    """The base config merged with CONFIG and the check's settings: the
    registered slices, --seed, --batch, --epochs, no checkpoints, GT boxes
    at test (the check measures learning, not the detector)."""
    cfg = Config(merge_dict(base_config().to_dict(), load_config(CONFIG).to_dict()))
    cfg.SEED = args.seed
    cfg.OUTPUT_DIR = f"{args.out}_seed{args.seed}"
    cfg.DATASETS.TRAIN = (TRAIN_NAME,)
    cfg.DATASETS.TEST = (TEST_NAME,)
    cfg.SOLVER.IMS_PER_BATCH = args.batch
    cfg.SOLVER.TOTAL_EPOCHS = args.epochs
    cfg.SOLVER.CHECKPOINT_PERIOD = 10_000_000
    cfg.TRAIN.PRINT_FREQ = 100
    cfg.TEST.TEST_BBOX_TYPE = "gt"
    cfg.MODEL.LOAD_DETS_TEST = False
    cfg.VAL.ERROR_TYPES = "ad,rete,re,te,proj"
    return cfg


def main(argv=None, device="cuda") -> dict:
    """Runs the check and returns the SWEEP dict; `device` unless --device
    names one."""
    args = parse_args(argv)
    device = entry_device("validate_scale", args.device or device)
    if not osp.isfile(osp.join(args.root, "meta.json")):
        raise SystemExit(f"scale dataset not found at {args.root} "
                         "(python -m gdrnet_tpu_torch.tools.gen_scale_dataset builds it)")
    meta = meta_from_json(args.root)
    train, test = select_records(meta, args.train_images, args.test_images)
    register(TRAIN_NAME, lambda: (meta, train))
    register(TEST_NAME, lambda: (meta, test))
    cfg = build_config(args)
    t0 = time.time()
    state, models, preempted = do_train(cfg, device=device)
    if preempted:
        raise SystemExit("validate_scale: training was interrupted (SIGTERM / SIGINT)")
    t_train = time.time() - t0
    results = do_test(cfg, state.model, models, test, output_dir=cfg.OUTPUT_DIR, device=device)
    print(results["_summary"], flush=True)
    sweep = {"seed": args.seed, "train_images": len(train), "test_images": len(test),
             "epochs": args.epochs, "train_secs": round(t_train, 1),
             "ad_10": float(results["Avg"]["ad_10"]),
             "mean_re": float(results["Avg"]["mean_re"]),
             "mean_te": float(results["Avg"]["mean_te"])}
    print("SWEEP " + json.dumps(sweep), flush=True)
    return sweep


if __name__ == "__main__":
    main()
