"""Benchmark: ROI pose-crop inference throughput on one card (counterpart of
the repository's bench.py).

Serves the flagship GDRN-R34 (256x256 ROI crops, 2D coordinates and region
attention: WITH_2D_COORD, REGION_ATTENTION) under bf16 autocast over a
large batch of data/synthetic.synthetic_roi_batch and reports crops/s.
Baseline: 5,000 crops/s, the north star of BASELINE.json.

By default it benches the int8 serving path (TEST.INT8 semantics:
models/quantize.py, calibrated on the bench batch); `--bf16` benches the
bf16 path; `--fold-bn` folds the BN statistics into the convs first
(utils/fold_bn.py).

Weights: `--ckpt` (a port checkpoint directory with last_checkpoint, or a
reference-layout .pth) with `--config` for a non-flagship model's dims;
without them, trained weights are taken from DEFAULT_CKPTS when one is
there, and random init (seeded, models/gdrn.init_weights) is the loud last
resort. The JSON line carries "ckpt" and, on the int8 path, the int8
against bf16 drift on the bench batch.

Timing: one untimed warm-up call, then `--iters` back-to-back calls timed
by CUDA events and fenced by a synchronize (engine/profiling.timed_calls),
the last call's poses checked finite. It runs on the card unless
`--device cpu` (host clock there).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "ckpt"
[, "int8_rot_drift_deg_mean", "int8_trans_rel_drift_max"]}.

Usage:
  python -m gdrnet_tpu_torch.tools.bench [--bf16] [--fold-bn] [--ckpt <ckpt dir | .pth>]
      [--config <cfg.py>] [--batch 1024] [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

import torch

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, merge_dict
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.checkpoint import load_weights
from gdrnet_tpu_torch.engine.profiling import timed_calls
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.models.quantize import calibrate_act_scales
from gdrnet_tpu_torch.ops.rotation import rot_angle_deg
from gdrnet_tpu_torch.tools import entry_device
from gdrnet_tpu_torch.utils.fold_bn import fold_batch_norms

BASELINE_CROPS_PER_SEC = 5000.0

# trained weights looked for when neither --ckpt nor --config is given,
# (checkpoint, config with its model dims); the first present wins: the
# flagship's training output (engine.train on configs/gdrn/synth/
# a6_cPnP_synth.py), then a locally saved one
DEFAULT_CKPTS = (
    ("output/gdrn/synth/a6_cPnP_synth/ckpt", "configs/gdrn/synth/a6_cPnP_synth.py"),
    ("checkpoints/bench_default/ckpt", "checkpoints/bench_default/config.py"),
)


def is_checkpoint(path: str) -> bool:
    """A .pth file, or a checkpoint directory of the port (last_checkpoint)."""
    return (osp.isfile(path) and path.endswith((".pth", ".pt"))) or osp.isfile(
        osp.join(path, "last_checkpoint"))


def bench_config(cfg_path: str | None) -> Config:
    """The flagship input assembly in bf16, with `cfg_path`'s model dims
    merged over it."""
    cfg = base_config()
    cfg.MODEL.CDPN.PNP_NET.WITH_2D_COORD = True
    cfg.MODEL.CDPN.PNP_NET.REGION_ATTENTION = True
    if cfg_path:
        cfg = Config(merge_dict(cfg.to_dict(), load_config(cfg_path).to_dict()))
    cfg.PARALLEL.DTYPE = "bfloat16"
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bf16", action="store_true", help="bench the bf16 path, not int8")
    p.add_argument("--fold-bn", action="store_true", help="fold BN into the convs first")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint directory of the port or a reference-layout .pth")
    p.add_argument("--config", default=None, help="model dims of a non-flagship checkpoint")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Prints the JSON line and returns it; `device` unless --device names one."""
    args = parse_args(argv)
    device = entry_device("bench", args.device or device)
    ckpt, cfg_path = args.ckpt, args.config
    if ckpt is None and cfg_path is None:
        for c_dir, c_cfg in DEFAULT_CKPTS:
            if is_checkpoint(c_dir) and osp.exists(c_cfg):
                ckpt, cfg_path = c_dir, c_cfg
                print(f"auto-detected trained weights: {ckpt}", file=sys.stderr)
                break
    if ckpt is None:
        print("WARNING: no trained checkpoint found "
              f"({' | '.join(c for c, _ in DEFAULT_CKPTS)}); benching RANDOM INIT weights",
              file=sys.stderr)
    cfg = bench_config(cfg_path)
    model = build_model(cfg, device=device)
    if ckpt:
        load_weights(model, ckpt)
        print(f"benching weights from {ckpt}", file=sys.stderr)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    if args.fold_bn:
        model = fold_batch_norms(model)

    net = cfg.MODEL.CDPN
    batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic_roi_batch(
        batch_size=args.batch, input_res=net.BACKBONE.INPUT_RES,
        out_res=net.BACKBONE.OUTPUT_RES, num_classes=net.ROT_HEAD.NUM_CLASSES).items()}
    scales = None if args.bf16 else calibrate_act_scales(model, [batch])
    predict = make_predict_step(model, int8_scales=scales)

    predict(batch)  # warm-up: cuDNN's algorithm choice, the allocator
    dt, out = timed_calls(lambda: predict(batch), args.iters, device)
    if not (torch.isfinite(out["rot"]).all() and torch.isfinite(out["trans"]).all()):
        raise AssertionError("non-finite poses in the benched forward")

    crops_per_sec = args.batch * args.iters / dt
    record = {
        "metric": "roi_pose_crops_per_sec_per_chip",
        "value": round(crops_per_sec, 1),
        "unit": "crops/s",
        "vs_baseline": round(crops_per_sec / BASELINE_CROPS_PER_SEC, 3),
        "ckpt": ckpt,
    }
    if scales:
        # int8 against bf16 on the bench batch: the quality cost of the
        # quantization the throughput is measured on
        r16 = make_predict_step(model)(batch)
        r8, t8 = out["rot"].float(), out["trans"].float()
        t16 = r16["trans"].float()
        ang = rot_angle_deg(r8, r16["rot"].float())
        rel = (t8 - t16).abs() / t16.abs().clamp_min(1e-3)
        record["int8_rot_drift_deg_mean"] = round(float(ang.mean()), 4)
        record["int8_trans_rel_drift_max"] = round(float(rel.max()), 5)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
