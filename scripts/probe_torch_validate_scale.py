#!/usr/bin/env python3
"""The held-out learning check (gdrnet_tpu_torch/tools/validate_scale.py) at
a cut size on one NVIDIA GPU, within a 1,200 s call.

1. `python -m gdrnet_tpu_torch.tools.gen_scale_dataset` in this process:
   GEN_TRAIN train and GEN_TEST test images at 640x480 (the flagship's
   frame), seed 1, into a temporary directory, on the card (B2 renders).
2. `python -m gdrnet_tpu_torch.tools.validate_scale` in this process for
   each seed of SEEDS with the flags of CHECK_ARGS: the flagship config
   (GDRN-R34, full width, unchanged), the first 200 train and 50 test
   records as the JAX tool slices them, 200 epochs at B=32: 1,200
   iterations, one seed in the call. Over them the config's LR schedule
   (a 1,000-iteration linear warm-up from 0.001 of 2e-4, then the cosine
   anneal that starts at 0.72 of the run) climbs to 2.0e-4 at iteration
   999, drops to 1.3e-4 and anneals to 0. The tool's defaults, 160 epochs
   of one iteration at B=128, end inside the warm-up at 3.2e-5, and 240
   iterations at B=32 at 4.8e-5.

Prints the card's name and power limit, the generator's wall seconds, and
for each seed its SWEEP line (ad_10, mean_re in degrees, mean_te in
metres, train_secs), the total loss and LR at every TRAIN.PRINT_FREQ-th
iteration (the trainer's metrics.json: one batch's loss, not a median),
its wall seconds and the launches of B1 (do_test's
ADD-S of the 4 symmetric objects) and B2 (every launch of the z-buffer
kernel, `rasterize_attr.launches`: the generator's renders; the train
loader reads the generator's xyz_crop pickles); the last line is
PROBE {json} with all of it.

Run from the repository root:
    python3 scripts/probe_torch_validate_scale.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os.path as osp
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gdrnet_tpu_torch import csrc  # noqa: E402
from gdrnet_tpu_torch.ops import kernels  # noqa: E402
from gdrnet_tpu_torch.tools import gen_scale_dataset, validate_scale  # noqa: E402

GEN_TRAIN, GEN_TEST = 64, 16
SEEDS = (0,)
CHECK_ARGS = ["--train-images", "200", "--test-images", "50", "--epochs", "200", "--batch", "32"]


def loss_trend(path: str) -> list:
    """(iteration, total loss, LR) of each row the trainer wrote to
    metrics.json."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [(r["iteration"], round(r["total_loss"], 4), float(f"{r['lr']:.4g}")) for r in rows]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_validate_scale: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for name in ("nn_min_dist", "rasterize_xyz", "jpeg_codec"):
        csrc.build(name)
    out = {"card": card, "gen_train_images": GEN_TRAIN, "gen_test_images": GEN_TEST,
           "check_args": CHECK_ARGS, "seeds": []}
    with tempfile.TemporaryDirectory(prefix="probe_validate_scale_") as work:
        root = osp.join(work, "synth")
        b2 = kernels.rasterize_attr.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            gen_scale_dataset.main(["--root", root, "--train-images", str(GEN_TRAIN),
                                    "--test-images", str(GEN_TEST), "--seed", "1"])
        out["gen_s"] = round(time.perf_counter() - t0, 1)
        out["gen_b2_launches"] = kernels.rasterize_attr.launches - b2
        print(f"[gen] {GEN_TRAIN} + {GEN_TEST} images in {out['gen_s']} s, "
              f"B2 {out['gen_b2_launches']} launches", flush=True)
        for seed in SEEDS:
            b1, b2 = kernels.nn_min_dist.launches, kernels.rasterize_attr.launches
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                sweep = validate_scale.main(["--root", root, "--seed", str(seed),
                                             "--out", osp.join(work, "vs")] + CHECK_ARGS)
            row = {"sweep": sweep, "wall_s": round(time.perf_counter() - t0, 1),
                   "b1_launches": kernels.nn_min_dist.launches - b1,
                   "b2_launches": kernels.rasterize_attr.launches - b2,
                   "loss_lr": loss_trend(osp.join(work, f"vs_seed{seed}", "metrics.json"))}
            out["seeds"].append(row)
            print("SWEEP " + json.dumps(sweep), flush=True)
            print(f"[seed {seed}] (iteration, total loss, lr): {row['loss_lr']}", flush=True)
            print(f"[seed {seed}] wall {row['wall_s']} s, B1 {row['b1_launches']}, "
                  f"B2 {row['b2_launches']}", flush=True)
    print("PROBE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
