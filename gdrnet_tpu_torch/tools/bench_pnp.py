"""PnP post-processing throughput of the port (counterpart of
tools/bench_pnp.py): the host loop (eval/pnp.py on the numpy stand-ins of
eval/cv_pnp.py, the reference's per-ROI solvePnPRansac,
gdrn_evaluator.py:316-435) and the bucket program on the device
(ops/device_pnp.pnp_from_maps_batch, TEST.DEVICE_PNP) in each
TEST.PNP_TYPE mode, on data/synthetic.synthetic_decoded_maps at 64x64 maps
with 0.5 px noise. One JSON line a path, in ROIs/s.

The device rounds are chained as the JAX tool chains them (each round's
refined pose is the next round's net pose) and timed with CUDA events after
one warm-up round that is not timed; each line also holds the peak device
memory of the timed rounds. It runs on the card, or on the CPU with
--device cpu (host clock there).

Usage: python -m gdrnet_tpu_torch.tools.bench_pnp [--batch 64] [--iters 4]
       [--modes ransac_pnp net_iter_pnp net_ransac_pnp] [--skip-host] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gdrnet_tpu_torch.data.synthetic import synthetic_decoded_maps
from gdrnet_tpu_torch.eval.pnp import correspondences_from_maps, pnp_ransac
from gdrnet_tpu_torch.ops.device_pnp import MODES, pnp_from_maps_batch
from gdrnet_tpu_torch.tools import entry_device


def host_rate(maps: tuple) -> float:
    """ROIs/s of the per-ROI host loop: correspondences, then RANSAC-EPnP."""
    mask, xyzn, c2d, _, _, K, extent, (im_w, im_h) = maps
    t0 = time.perf_counter()
    for j in range(len(mask)):
        img_pts, mdl_pts = correspondences_from_maps(mask[j], xyzn[j], c2d[j], im_w, im_h,
                                                     extent)
        pnp_ransac(mdl_pts, img_pts, K, method="epnp", ransac=True)
    return len(mask) / (time.perf_counter() - t0)


def device_rate(maps: tuple, mode: str, iters: int,
                device: torch.device) -> tuple[float, int | None]:
    """(ROIs/s, peak bytes allocated on a CUDA device, else None) of `iters`
    chained rounds of the bucket program in `mode` on `device`, after one
    untimed round."""
    mask, xyzn, c2d, _, _, K, extent, (im_w, im_h) = maps
    B = len(mask)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inputs = (on(mask), on(xyzn), on(c2d), on(np.tile([[im_w, im_h]], (B, 1)).astype(np.float32)),
              on(np.tile(extent, (B, 1))), on(np.tile(K, (B, 1, 1))))
    valid = torch.ones(B, dtype=torch.bool, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    rot0 = on(np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)))
    trans0 = on(np.tile([[0.0, 0.0, 0.5]], (B, 1)).astype(np.float32))

    def rounds(n: int) -> torch.Tensor:
        R, t = rot0, trans0
        for _ in range(n):
            R, t = pnp_from_maps_batch(*inputs, R, t, valid, mode=mode, generator=gen)
        return t

    rounds(1)
    if device.type != "cuda":
        t0 = time.perf_counter()
        t = rounds(iters)
        dt = time.perf_counter() - t0
        peak = None  # not measured on the CPU
    else:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = rounds(iters)
        end.record()
        torch.cuda.synchronize(device)
        dt = start.elapsed_time(end) / 1e3
        peak = torch.cuda.max_memory_allocated(device)
    if not torch.isfinite(t).all():
        raise FloatingPointError(f"bench_pnp: non-finite translations in {mode}")
    return B * iters / dt, peak


def run(batch: int = 64, iters: int = 4, modes=MODES, host: bool = True,
        device="cuda") -> list[dict]:
    """The tool's JSON rows."""
    device = torch.device(device)
    maps = synthetic_decoded_maps(np.random.RandomState(0), batch, noise_px=0.5, t_jitter=0.02)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = []
    if host:
        rows.append({"metric": "pnp_host_numpy", "value": host_rate(maps), "unit": "rois/s",
                     "batch": batch})
    for mode in modes:
        rate, peak = device_rate(maps, mode, iters, device)
        rows.append({"metric": f"pnp_device_{mode}", "value": rate, "unit": "rois/s",
                     "batch": batch, "iters": iters, "device": where,
                     "peak_mem_mib": None if peak is None else peak / 2 ** 20})
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    p.add_argument("--skip-host", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    rows = run(args.batch, args.iters, args.modes, not args.skip_host,
               entry_device("bench_pnp", args.device))
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
