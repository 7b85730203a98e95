"""Profiling hooks: torch.profiler traces and the warm-up-aware step timer
(counterpart of gdrnet_tpu/engine/profiling.py).

`trace(logdir)` wraps a region in a torch.profiler session (the CPU, and the
card's activity when the work is on a CUDA device) and writes a Chrome
trace (chrome://tracing, Perfetto) into `logdir` when the region ends;
`annotate(name)` names a region inside it. `StepTimer` is the reference's
warm-up-aware compute / process split (gdrn_evaluator.py:545-624), with the
JAX package's semantics.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None, device: torch.device | str | None = None,
          filename: str = "trace.json"):
    """torch.profiler session over the region, its Chrome trace written to
    `logdir`/`filename` at the end (after the card's queue has drained); a
    no-op when `logdir` is falsy. The card is traced when `device` is a CUDA
    device, or, with no device given, when a card is available. Yields the
    profiler (None for the no-op)."""
    if not logdir:
        yield None
        return
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(osp.join(logdir, filename))


def timed_calls(fn, iters: int, device: torch.device | str):
    """(seconds, last result) of `iters` back-to-back calls of fn(): on a
    CUDA device by events recorded before the first and after the last call,
    then a synchronize, so that the time is the card's; elsewhere by the
    host clock. The caller warms up first."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return time.perf_counter() - t0, out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3, out


def annotate(name: str):
    """A named region inside a trace (a row of its own on the timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Warm-up-aware split timing (gdrn_evaluator.py:545-624 semantics):
    per-step durations accumulate into named buckets, skipping the first
    `warmup` steps; report() gives per-step means."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.totals: dict[str, float] = {}
        self.count = 0
        self._t0: float | None = None
        self._bucket: str | None = None

    def start(self, bucket: str) -> None:
        self._t0 = time.perf_counter()
        self._bucket = bucket

    def stop(self) -> None:
        assert self._t0 is not None and self._bucket is not None
        if self.count >= self.warmup:
            self.totals[self._bucket] = (self.totals.get(self._bucket, 0.0)
                                         + time.perf_counter() - self._t0)
        self._t0 = None

    def step_done(self) -> None:
        self.count += 1

    def report(self) -> dict[str, float]:
        n = max(self.count - self.warmup, 1)
        return {f"{k}_s_per_step": v / n for k, v in self.totals.items()}
