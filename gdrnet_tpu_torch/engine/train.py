"""CLI entry point: python -m gdrnet_tpu_torch.engine.train --config-file <cfg.py>
[--eval-only] [--resume] [--data-root ...] [KEY.PATH=value ...]
(counterpart of gdrnet_tpu/engine/train.py:18-133).

The reference's main_gdrn.py (core/gdrn_modeling/main_gdrn.py:37-126 +
train_gdrn.sh/test_gdrn.sh): load the layered config, derive OUTPUT_DIR from
the config path when it is "auto", then train and test on DATASETS.TEST[0],
or with --eval-only test the weights of MODEL.WEIGHTS (a reference-layout
.pth or a checkpoint directory), else of the newest checkpoint under
OUTPUT_DIR/ckpt. The results go to OUTPUT_DIR/results.json beside the BOP19
CSV. It runs on the CUDA card; main(argv, device="cpu") runs it on the CPU.

On N GPUs of one machine, one process a GPU (data-parallel training,
sharded testing; engine/trainer.py, engine/tester.py):
  torchrun --standalone --nproc_per_node=N -m gdrnet_tpu_torch.engine.train \
      --config-file <cfg.py> [--eval-only] [KEY.PATH=value ...]
(or python -m torch.distributed.run with the same arguments). Each process
joins the NCCL group on its LOCAL_RANK's card; SOLVER.IMS_PER_BATCH is the
global batch, split evenly between the ranks. Rank 0 writes the checkpoints,
metrics.json, results.json and the CSV; every rank logs to OUTPUT_DIR/
log[.rankR].txt.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, apply_opts, merge_dict
from gdrnet_tpu_torch.parallel import multihost as mh


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GDR-Net (PyTorch port) train/test")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("opts", nargs="*", default=[],
                   help="KEY.PATH=value overrides")
    return p.parse_args(argv)


def setup(args) -> Config:
    cfg = base_config()
    file_cfg = load_config(args.config_file)
    cfg = Config(merge_dict(cfg.to_dict(), file_cfg.to_dict()))
    if args.opts:
        apply_opts(cfg, args.opts)
    if cfg.OUTPUT_DIR == "auto":
        # reference main_gdrn.py:44-46: derive from the config file path
        stem = osp.splitext(args.config_file)[0]
        stem = stem.split("configs/")[-1]
        cfg.OUTPUT_DIR = osp.join(cfg.OUTPUT_ROOT, stem)
    if cfg.DEBUG:
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.TRAIN.PRINT_FREQ = 1
    # dump the resolved config into the run dir for reproducibility
    # (reference default_args_setup.py:102-110)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if mh.is_main_process():
        cfg.dump(osp.join(cfg.OUTPUT_DIR, "config_dump.json"))
    return cfg


def _dump_results(results, out_dir):
    """Write do_test's result dict as OUTPUT_DIR/results.json (numpy scalars
    coerced, other leaves by repr): the per-object table, the BOP error
    matrix and the timing split, next to the CSV."""

    def _clean(v):
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_clean(x) for x in v]
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        return repr(v)

    path = osp.join(out_dir, "results.json")
    with open(path, "w") as f:
        json.dump(_clean(results), f, indent=1)
    return path


def _test(cfg, model, data_root: str, device) -> dict:
    from gdrnet_tpu_torch.data.dataset_factory import resolve
    from gdrnet_tpu_torch.data.model_store import ObjectModels
    from gdrnet_tpu_torch.engine.tester import do_test

    meta, records = resolve(cfg.DATASETS.TEST[0], data_root)
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    results = do_test(cfg, model, models, records, output_dir=cfg.OUTPUT_DIR,
                      data_root=data_root, device=device)
    if mh.is_main_process():
        print(results["_summary"])
        _dump_results(results, cfg.OUTPUT_DIR)
    return results


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    device = torch.device(device)
    # a real config is hours of GPU work: without the card, stop here rather
    # than fall back to the host
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gdrnet_tpu_torch.engine.train: no CUDA card is available "
                           "(torch.cuda.is_available() is false)")
    # under a launcher: join the process group (NCCL on the card, gloo on the CPU)
    joined = not torch.distributed.is_initialized() and mh.maybe_init_distributed(
        backend="nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(setup(args), args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _run(cfg, args, device):
    """Train then test, or test alone with --eval-only, in this process."""
    from gdrnet_tpu_torch.engine.checkpoint import load_weights
    from gdrnet_tpu_torch.engine.trainer import do_train
    from gdrnet_tpu_torch.models.gdrn import build_model

    if args.eval_only:
        model = build_model(cfg, device=device)
        weights = cfg.MODEL.WEIGHTS or osp.join(cfg.OUTPUT_DIR, "ckpt")
        # the model's weights alone: eval does not depend on the optimizer
        # state the checkpoint was trained with
        load_weights(model, weights)
        return _test(cfg, model, args.data_root, device)

    state, _, was_preempted = do_train(cfg, resume=args.resume, data_root=args.data_root,
                                       device=device)
    if was_preempted:
        # exit promptly so the scheduler can reschedule; eval belongs to the
        # resumed run (or --eval-only), not the teardown window
        print("preempted: skipping post-train eval; resume with --resume")
        return None
    if cfg.DATASETS.TEST:
        return _test(cfg, state.model, args.data_root, device)
    return None


if __name__ == "__main__":
    main()
