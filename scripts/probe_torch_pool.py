#!/usr/bin/env python3
"""Probe of the device-side training input on one card: chip_smoke.py's
phases that exercise it, alone, at the smoke's sizes.

Builds the kernels, writes chip_smoke.py's train split (the ten zoo meshes at
640x480, 512 instances, no xyz_crop pickles) into a temporary directory, then
runs, from chip_smoke.py:
  1. [train_loop]: the flagship config trained by do_train from the
     device-resident pool with its refresh, saved, resumed from the pool's
     cache (the host loader alone timed beside it);
  2. [pool_parity]: the pool against the mapper, its decode against the
     CPU's, device_train_batch and every device_augment op card against CPU;
  3. [bench_train_loader]: tools/bench_train --with-loader for the host,
     pool, device-prep and device-aug pipelines at B=128.
Each phase prints its chip_smoke line; the card's name and power limit come
first. With --quick the split, the pool and the bench leg are cut to a
quarter, for a first run of new code on a card.

Run from the repository root:  python3 scripts/probe_torch_pool.py [--quick]
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_pool: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    if "--quick" in sys.argv:
        cs.LOOP_IMAGES, cs.LOOP_SAVE, cs.LOOP_ITERS = 4, 2, 4
        cs.POOL_PARITY_ROWS, cs.BT_POOL_RECORDS, cs.BT_LOADER_ITERS = 16, 64, 1
    cs.phase_build(("rasterize_xyz",))
    gsd = cs.mesh_tools()
    cfg = cs.merged_config(cs.FLAGSHIP)
    cfg32 = cs.merged_config(cs.FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    state_dict = cs.init_weights(cs.build_model(cfg32, device="cpu"),
                                 torch.Generator().manual_seed(0)).state_dict()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        launches, rate, loop = cs.phase_train_loop(cfg, state_dict, gsd, root, card)
        t1 = time.perf_counter()
        parity = cs.phase_pool_parity(root, loop["weights"], card)
        t2 = time.perf_counter()
        bench = cs.bench_train_loader(root, card)
        t3 = time.perf_counter()
    print(f"probe_torch_pool: train_loop {t1 - t0:.1f} s (B2 {launches}), pool_parity "
          f"{t2 - t1:.1f} s (B2 {parity}), bench_train_loader {t3 - t2:.1f} s (B2 {bench})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
