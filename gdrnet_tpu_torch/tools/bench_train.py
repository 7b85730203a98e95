"""Train-step throughput on one card, one JSON line a batch size
(counterpart of the repository's tools/bench_train.py).

The flagship GDRN-R34 with the full loss stack (PM loss over 3,000 points,
64 regions, centroid and z) and Ranger: the training hot loop, not a
stripped forward. Three legs:

- default, the step: ONE synthetic device-resident batch, the step alone
  (engine/steps.make_train_step), `--iters` steps after one that is left
  out, timed by CUDA events. Prints `train_rois_per_sec_per_chip`.
- `--with-loader`: the real input path, the objects engine/trainer.do_train
  uses (build_train_objects, build_input_pipeline: the mapper on the
  loader's threads, to_device, the step) over an on-disk split, with the
  host's wait for each next batch overlapping the step as do_train's loop
  does. Prints `sustained_train_rois_per_sec` with the host data ms a step.
  `--pipeline` takes any of host (the mapper on the host), device-prep
  (INPUT.DEVICE_PREPROCESS: raw frames, crops and targets on the card),
  device-aug (device-prep with INPUT.DEVICE_COLOR_AUG) and pool
  (TRAIN.DEVICE_RESIDENT_POOL with POOL_REFRESH: the split mapped once
  onto the card, one refresh chunk drained a step; its line adds the pool's
  rows, MiB, map and upload seconds and the rows refreshed). `build_s` is
  the seconds to the first batch, the pool's fill included. Where a record
  has no XYZ pickle, the mapper renders it on B2.
- `--audit`: the FLOP audit of one train step (forward, backward and the
  optimizer) and of one eval forward. FLOPs from
  torch.utils.flop_counter.FlopCounterMode (convolutions and matrix
  products, forward and backward: every tap of a kernel window, those on
  the zero padding too); `fwd_gflops_on_input` counts only the taps that
  fall on the input, as XLA's cost_analysis counts a convolution
  (analytic_flops); `step_eager_gb` from EagerBytes below,
  an upper bound of the step's HBM traffic. On a card it adds the step's
  time and its share of the card's peaks (PEAKS: the public spec of the
  part nvidia-smi names) as `mfu` and `hbm_frac`; `--device cpu` gives the
  counts only.

Every leg runs on the card unless `--device cpu` (host clock there).

Usage:
  python -m gdrnet_tpu_torch.tools.bench_train [--batch-sizes 24,64,128] [--iters 6]
  python -m gdrnet_tpu_torch.tools.bench_train --with-loader \\
      --config-file configs/gdrn/synth/a6_cPnP_synth.py --data-root datasets/BOP_DATASETS \\
      [--batch-sizes 64,256] [--workers 4,8] [--iters 30] [--max-records 512]
      [--pipeline host,device-prep,device-aug,pool] [KEY=value ...]
  python -m gdrnet_tpu_torch.tools.bench_train --audit [--batch-sizes 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, apply_opts, merge_dict
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.profiling import timed_calls
from gdrnet_tpu_torch.engine.steps import make_predict_step, make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.engine.trainer import build_input_pipeline, build_train_objects
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule
from gdrnet_tpu_torch.tools import entry_device

# public spec of each part, by torch.cuda.get_device_name: (dense bf16
# tensor-core TFLOP/s, HBM GB/s); H100 SXM5 80GB
PEAKS = {"NVIDIA H100 80GB HBM3": (989.4, 3350.0)}
PIPELINES = ("host", "device-prep", "device-aug", "pool")


def step_config() -> Config:
    """The flagship step's config (tools/bench_train.py:263-274): 2D
    coordinates, region attention, PM normalised by extent, centroid and z
    losses at weight 1, 64 regions, bf16, Ranger at lr 1e-4 without weight
    decay."""
    cfg = base_config()
    pnp = cfg.MODEL.CDPN.PNP_NET
    pnp.WITH_2D_COORD = True
    pnp.REGION_ATTENTION = True
    pnp.PM_NORM_BY_EXTENT = True
    pnp.CENTROID_LW = 1.0
    pnp.Z_LW = 1.0
    cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 64
    cfg.PARALLEL.DTYPE = "bfloat16"
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-4, weight_decay=0)
    return cfg


def train_objects(cfg, device: torch.device):
    """(state, step) of a seeded model and Ranger over a 10,000-update schedule."""
    model = init_weights(build_model(cfg, device=device), torch.Generator().manual_seed(0))
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-4, 10000))
    return create_train_state(model, opt), make_train_step(cfg, model, opt)


def step_batch(cfg, batch_size: int, device: torch.device) -> dict:
    """A synthetic batch of the config's shapes (at step_config: 256^2 crops,
    64^2 maps, 13 classes, 3,000 model points, 64 regions), on `device`."""
    net = cfg.MODEL.CDPN
    return {k: torch.from_numpy(v).to(device) for k, v in synthetic_roi_batch(
        batch_size=batch_size, input_res=net.BACKBONE.INPUT_RES,
        out_res=net.BACKBONE.OUTPUT_RES, num_classes=net.ROT_HEAD.NUM_CLASSES,
        num_points=net.PNP_NET.NUM_PM_POINTS, num_regions=net.ROT_HEAD.NUM_REGIONS).items()}


def bench_step(args, device: torch.device) -> list[dict]:
    cfg = step_config()
    rows = []
    for B in [int(x) for x in args.batch_sizes.split(",")]:
        state, step = train_objects(cfg, device)
        batch = step_batch(cfg, B, device)
        gen = torch.Generator(device=device).manual_seed(1)
        _, m = step(state, batch, gen)  # warm-up, left out
        if not np.isfinite(float(m["total_loss"])):
            raise AssertionError(f"non-finite loss at the warm-up step: {float(m['total_loss'])}")
        dt, (_, m) = timed_calls(lambda: step(state, batch, gen), args.iters, device)
        dt /= args.iters
        rows.append(emit({"metric": "train_rois_per_sec_per_chip", "batch": B,
                          "value": round(B / dt, 1), "unit": "ROIs/s",
                          "ms_per_step": round(dt * 1e3, 1),
                          "loss": round(float(m["total_loss"]), 4)}))
    return rows


def pipeline_config(cfg, pipeline: str) -> None:
    """Sets cfg's input settings for one --pipeline."""
    cfg.INPUT.DEVICE_PREPROCESS = pipeline in ("device-prep", "device-aug")
    cfg.INPUT.DEVICE_COLOR_AUG = pipeline == "device-aug"
    cfg.TRAIN.DEVICE_RESIDENT_POOL = pipeline == "pool"
    cfg.TRAIN.POOL_REFRESH = pipeline == "pool"


def bench_with_loader(args, device: torch.device) -> list[dict]:
    """Sustained loader -> to_device -> step throughput on a split on disk."""
    pipelines = args.pipeline.split(",")
    for pipeline in pipelines:
        if pipeline not in PIPELINES:
            raise SystemExit(f"--pipeline {pipeline}: one of {', '.join(PIPELINES)}")
    rows = []
    for pipeline in pipelines:
        for B in [int(x) for x in args.batch_sizes.split(",")]:
            for workers in [int(x) for x in args.workers.split(",")]:
                rows.append(emit(loader_run(args, device, pipeline, B, workers)))
    return rows


def loader_run(args, device: torch.device, pipeline: str, B: int, workers: int) -> dict:
    cfg = Config(merge_dict(base_config().to_dict(), load_config(args.config_file).to_dict()))
    if args.opts:
        apply_opts(cfg, args.opts)
    cfg.SOLVER.IMS_PER_BATCH = B
    cfg.DATALOADER.NUM_WORKERS = workers
    pipeline_config(cfg, pipeline)
    cfg.TRAIN.POOL_CACHE = False  # every run maps its pool
    _, records, records2, _, mapper = build_train_objects(cfg, args.data_root, device)
    if args.max_records and len(records) > args.max_records:
        records = records[:args.max_records]
    t_build = time.perf_counter()
    loader, to_device, refresher = build_input_pipeline(cfg, records, records2, mapper, seed=1,
                                                        device=device)
    loader_iter = iter(loader)
    try:
        batch = to_device(next(loader_iter), 0)
        build_s = time.perf_counter() - t_build
        state, step = train_objects(cfg, device)
        gen = torch.Generator(device=device).manual_seed(1)
        # warm-up: PyTorch's kernels, and the loader's queue fills
        _, m = step(state, batch, gen)
        if not np.isfinite(float(m["total_loss"])):
            raise AssertionError("non-finite loss at the warm-up step")
        batch = to_device(next(loader_iter), 1)
        data_times = []
        t0 = time.perf_counter()
        for i in range(args.iters):
            _, m = step(state, batch, gen)
            # the next batch is fetched while the card runs the step, as in
            # do_train's loop
            td = time.perf_counter()
            batch = to_device(next(loader_iter), i + 2)
            data_times.append(time.perf_counter() - td)
            if refresher is not None:
                refresher.drain(max_chunks=1)
        loss = float(m["total_loss"])  # waits for the last step
        dt = (time.perf_counter() - t0) / args.iters
    finally:
        loader_iter.close()
        if refresher is not None:
            refresher.stop()
    row = {"metric": "sustained_train_rois_per_sec", "pipeline": pipeline, "batch": B,
           "workers": workers, "value": round(B / dt, 1), "unit": "ROIs/s",
           "ms_per_step": round(dt * 1e3, 1),
           "data_ms_per_step": round(1e3 * sum(data_times) / len(data_times), 1),
           "records": len(records), "build_s": round(build_s, 1), "loss": round(loss, 4)}
    if pipeline == "pool":
        st = to_device.pool.stats
        row.update(pool_rows=st["rows"], pool_mib=round(st["nbytes"] / 2 ** 20, 1),
                   pool_map_s=round(st["map_s"], 2), pool_upload_s=round(st["upload_s"], 3),
                   refreshed=refresher.refreshed)
    return row


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class EagerBytes(TorchDispatchMode):
    """Counts the operand bytes plus the result bytes of every aten op
    dispatched under it (views, which move nothing, left out): the traffic
    of eager execution, each op reading its inputs from memory and writing
    its outputs to it, with no reuse through the L2 cache or registers
    across ops. An upper bound of the HBM traffic, not a hardware count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        returns = func._schema.returns
        view = returns and all(r.alias_info is not None and not r.alias_info.is_write
                               for r in returns)
        if not view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


def analytic_flops(model: nn.Module, run, in_bounds: bool = False) -> int:
    """2 x the multiply-adds of every Conv2d, ConvTranspose2d and Linear of
    `model` in run(): every tap of each kernel window, or with in_bounds
    only the taps that fall on the input (none on the zero padding, nor on
    the border a transposed conv crops)."""
    total = [0]

    def taps(n_in, n_out, k, s, p, d, transposed):
        if transposed:  # input i reaches output i * s - p + j
            return sum(0 <= i * s - p + j < n_out for i in range(n_in) for j in range(k))
        return sum(0 <= o * s - p + j * d < n_in for o in range(n_out) for j in range(k))

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, nn.Linear):
            total[0] += 2 * x.numel() // x.shape[-1] * mod.in_features * mod.out_features
            return
        tr = isinstance(mod, nn.ConvTranspose2d)
        if in_bounds:
            n = 1
            for a in (0, 1):
                n *= taps(x.shape[2 + a], out.shape[2 + a], mod.kernel_size[a], mod.stride[a],
                          mod.padding[a], mod.dilation[a], tr)
        else:
            k = mod.kernel_size[0] * mod.kernel_size[1]
            n = k * (x.shape[2] * x.shape[3] if tr else out.shape[2] * out.shape[3])
        total[0] += 2 * x.shape[0] * mod.in_channels * mod.out_channels // mod.groups * n

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def card_peaks(device: torch.device) -> tuple[str, str, float, float]:
    """(name, power limit, peak bf16 TFLOP/s, peak HBM GB/s) of the card."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise SystemExit(f"--audit: no peak on record for {name!r} (PEAKS: {sorted(PEAKS)})")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
        power = smi.stdout.strip().split(",")[-1].strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        power = "not measured"
    return (name, power) + PEAKS[name]


def audit_step(args, device: torch.device) -> list[dict]:
    """The FLOP audit, one JSON line a batch size (module docstring)."""
    cfg = step_config()
    rows = []
    for B in [int(x) for x in args.batch_sizes.split(",")]:
        state, step = train_objects(cfg, device)
        batch = step_batch(cfg, B, device)
        gen = torch.Generator(device=device).manual_seed(1)
        predict = make_predict_step(state.model)
        with FlopCounterMode(display=False) as fwd_count:
            predict(batch)
        on_input = analytic_flops(state.model, lambda: predict(batch), in_bounds=True)
        eager = EagerBytes()
        with FlopCounterMode(display=False) as step_count, eager:
            step(state, batch, gen)
        f_fwd, f_step = fwd_count.get_total_flops(), step_count.get_total_flops()
        rec = {
            "metric": "train_step_mfu_audit", "batch": B,
            "step_gflops": round(f_step / 1e9, 3),
            "fwd_gflops": round(f_fwd / 1e9, 3),
            "fwd_gflops_on_input": round(on_input / 1e9, 3),
            "step_fwd_flop_ratio": round(f_step / max(f_fwd, 1.0), 2),
            "step_eager_gb": round(eager.bytes / 1e9, 3),
            "step_aten_ops": eager.ops,
            "backend": device.type,
        }
        if device.type == "cuda":
            name, power, peak_tflops, peak_gbs = card_peaks(device)
            _, m = step(state, batch, gen)  # warm-up, left out
            if not np.isfinite(float(m["total_loss"])):
                raise AssertionError("non-finite loss at the warm-up step")
            dt, _ = timed_calls(lambda: step(state, batch, gen), args.iters, device)
            dt /= args.iters
            tflops = f_step / dt / 1e12
            gbs = eager.bytes / dt / 1e9
            rec.update(
                ms_per_step=round(dt * 1e3, 3), rois_per_sec=round(B / dt, 1),
                achieved_tflops=round(tflops, 2), mfu=round(tflops / peak_tflops, 4),
                achieved_hbm_gbs=round(gbs, 1), hbm_frac=round(gbs / peak_gbs, 4),
                card=name, power_limit=power, peak_bf16_tflops=peak_tflops,
                peak_hbm_gbs=peak_gbs)
        rows.append(emit(rec))
    return rows


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch-sizes", default=None,
                   help="comma list; 24,64,128 (step), 64,256 (--with-loader), 256 (--audit)")
    p.add_argument("--iters", type=int, default=None,
                   help="timed steps; 6 (step, --audit), 30 (--with-loader)")
    p.add_argument("--audit", action="store_true", help="FLOP audit of the train step")
    p.add_argument("--with-loader", action="store_true")
    p.add_argument("--config-file", default="configs/gdrn/synth/a6_cPnP_synth.py")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--pipeline", default="host",
                   help="comma list of host, device-prep, device-aug, pool (--with-loader)")
    p.add_argument("--workers", default="4", help="comma list of loader thread counts")
    p.add_argument("--max-records", type=int, default=0,
                   help="truncate the record list (0: all)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("opts", nargs="*", default=[],
                   help="KEY.PATH=value overrides of --config-file (--with-loader)")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> list[dict]:
    """Prints one JSON line a batch size (a batch size and worker count with
    --with-loader) and returns them; `device` unless --device names one."""
    args = parse_args(argv)
    device = entry_device("bench_train", args.device or device)
    if args.audit:
        args.batch_sizes, args.iters = args.batch_sizes or "256", args.iters or 6
        return audit_step(args, device)
    if args.with_loader:
        args.batch_sizes, args.iters = args.batch_sizes or "64,256", args.iters or 30
        return bench_with_loader(args, device)
    args.batch_sizes, args.iters = args.batch_sizes or "24,64,128", args.iters or 6
    return bench_step(args, device)


if __name__ == "__main__":
    main()
