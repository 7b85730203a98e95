"""Strip the optimizer state from a checkpoint of the port, keeping the model
(parameters and BN statistics) and the iteration (counterpart of the
repository's tools/strip_ckpt.py; the reference's
tools/remove_optim_from_ckpt.py:18-30 publishes eval-only checkpoints so).

The source is a checkpoint directory (engine/checkpoint.py: its newest
model_{iter:07d}.pth by last_checkpoint) or one such .pth; the output
directory gets model_{iter:07d}.pth holding {"model", "iteration"} and its
own last_checkpoint, so engine/checkpoint.load_weights, the predict tool
(--ckpt) and `engine.train --eval-only` (MODEL.WEIGHTS) read it as they read
the source. Host only: no device is touched.

Usage:
  python -m gdrnet_tpu_torch.tools.strip_ckpt --ckpt-dir output/exp/ckpt --out output/exp/ckpt_slim
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager


def strip(src: str, out: str) -> str:
    """Write the slim checkpoint of `src` (a directory or a .pth) under the
    directory `out`; returns its path."""
    path = src
    if osp.isdir(src):
        step = CheckpointManager(src).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {src}")
        path = CheckpointManager(src).path(step)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    slim = {"model": ckpt["model"], "iteration": int(ckpt["iteration"])}
    dst = CheckpointManager(out, max_to_keep=1)
    dst_path = dst.path(slim["iteration"])
    torch.save(slim, dst_path + ".tmp")
    os.replace(dst_path + ".tmp", dst_path)
    with open(osp.join(dst.ckpt_dir, "last_checkpoint"), "w") as f:
        f.write(osp.basename(dst_path))
    return dst_path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt-dir", required=True, help="a checkpoint directory or one .pth")
    p.add_argument("--out", required=True, help="the slim checkpoint's directory")
    args = p.parse_args(argv)
    path = strip(args.ckpt_dir, args.out)
    print(f"saved slim checkpoint {osp.basename(path)} to {args.out}", flush=True)
    return path


if __name__ == "__main__":
    main()
