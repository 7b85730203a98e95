"""Metric writers (counterpart of gdrnet_tpu/engine/writers.py): console
printer with ETA + metrics.json + optional tensorboard — the reference's
MyCommonMetricPrinter / MyJSONWriter / MyTensorboardXWriter
(core/utils/my_writer.py:14-266) around detectron2's EventStorage, collapsed
into one small EventLog + writer set. metrics.json has the JAX package's
lines and keys.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import os.path as osp
import time
from collections import defaultdict, deque

import torch

logger = logging.getLogger("gdrnet_tpu_torch")


class EventLog:
    """Rolling scalar store (EventStorage analogue)."""

    def __init__(self, window: int = 20):
        self.window = window
        self.hist: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self.latest: dict[str, float] = {}
        self.iter = 0

    def put(self, **scalars) -> None:
        for k, v in scalars.items():
            v = float(v)
            self.hist[k].append(v)
            self.latest[k] = v

    def median(self, key: str) -> float:
        vals = sorted(self.hist[key])
        return vals[len(vals) // 2] if vals else 0.0

    def mean(self, key: str) -> float:
        vals = self.hist[key]
        return sum(vals) / len(vals) if vals else 0.0


class ConsoleWriter:
    """Console line with eta/iter/losses/lr (MyCommonMetricPrinter,
    my_writer.py:14-120)."""

    def __init__(self, max_iter: int, device="cpu"):
        self.max_iter = max_iter
        self.device = torch.device(device)
        self._last: tuple | None = None  # (iter, wall time) at last write

    def _mem(self) -> str:
        """Peak device memory allocated by PyTorch on a CUDA device (the
        reference prints max_mem, my_writer.py console line); empty on the
        CPU."""
        if self.device.type != "cuda":
            return ""
        return f"  mem: {torch.cuda.max_memory_allocated(self.device) / 2**20:.0f}M"

    def write(self, ev: EventLog) -> None:
        it = ev.iter
        data_t = ev.mean("time/data")
        step_t = ev.mean("time/step")
        # ETA from the wall-clock rate between writes: the trainer only
        # syncs with the device at print boundaries, so the sampled "step"
        # time there includes the drain of every pipelined iter since the
        # last boundary — extrapolating it per-iter overstates ETA by ~the
        # print frequency. Wall-clock delta / iter delta is the true rate.
        now = time.perf_counter()
        per_iter = step_t
        if self._last is not None and it > self._last[0]:
            per_iter = (now - self._last[1]) / (it - self._last[0])
        self._last = (it, now)
        eta = datetime.timedelta(
            seconds=int(per_iter * max(self.max_iter - it, 0))) if per_iter else "?"
        losses = "  ".join(
            f"{k.removeprefix('loss_')}: {ev.median(k):.4g}"
            for k in sorted(ev.latest) if k.startswith("loss") or k == "total_loss")
        lr = ev.latest.get("lr", 0.0)
        logger.info(
            f"iter {it}/{self.max_iter}  eta: {eta}  {losses}  lr: {lr:.3e}  "
            f"data: {data_t:.3f}s  step: {step_t:.3f}s{self._mem()}")


class JsonWriter:
    """Append-only metrics.json (MyJSONWriter, my_writer.py:123-160)."""

    def __init__(self, path: str):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self.path = path

    def write(self, ev: EventLog) -> None:
        row = {"iteration": ev.iter, "time": time.time()}
        row.update(ev.latest)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class TensorboardWriter:
    """Optional: no-op if tensorboardX/tensorboard is unavailable."""

    def __init__(self, log_dir: str):
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except ImportError:
            logger.info("tensorboard unavailable; TB writer disabled")

    def write(self, ev: EventLog) -> None:
        if self.tb is None:
            return
        for k, v in ev.latest.items():
            self.tb.add_scalar(k, v, ev.iter)

    def close(self):
        if self.tb is not None:
            self.tb.close()


def setup_logger(output_dir: str | None = None, rank: int = 0,
                 name: str = "gdrnet_tpu_torch") -> logging.Logger:
    """Rank-aware logger (reference lib/utils/setup_logger.py): console on
    rank 0, per-rank file under output_dir."""
    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.handlers.clear()
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s", "%m%d %H:%M:%S")
    if rank == 0:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        suffix = f".rank{rank}" if rank else ""
        fh = logging.FileHandler(osp.join(output_dir, f"log{suffix}.txt"))
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    return lg
