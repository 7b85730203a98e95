"""The train loader: a threaded prefetching iterator over the mapper
(counterpart of gdrnet_tpu/data/loader.py:27-110, TrainLoader).

Replaces the reference's torch DataLoader stack (build_gdrn_train_loader,
core/gdrn_modeling/data_loader.py:657-765 + my_build_batch_data_loader): a
pool of worker threads runs the numpy mapper and a bounded queue feeds the
train step; dual-dataset TRAIN2_RATIO mixing (engine.py:157-165,232-235) is a
stream-level mix. Threads, not worker processes, as in the JAX package: the
mapper renders missing XYZ ground truth with the CUDA z-buffer kernel, and a
forked worker cannot use CUDA. InferenceLoader comes with do_test (ROADMAP.md
A7).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from gdrnet_tpu_torch.data.mapper import collate
from gdrnet_tpu_torch.data.samplers import repeat_factor_training_sampler, training_sampler

PREFETCH_BATCHES = 4  # the queue holds this many batches of mapped samples


class TrainLoader:
    """Infinite batched iterator: records + mapper -> batch dicts. With
    num_workers=1 the batches come out in a fixed order."""

    def __init__(self, records: list[dict], mapper, batch_size: int,
                 sampler_name: str = "TrainingSampler", repeat_thresh: float = 0.0,
                 seed: int = 0, num_workers: int = 4,
                 records2: list[dict] | None = None, ratio2: float = 0.0):
        self.records = records
        self.records2 = records2 or []
        self.ratio2 = ratio2 if self.records2 else 0.0
        self.mapper = mapper
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        if sampler_name == "RepeatFactorTrainingSampler":
            labels = [r["label"] for r in records]
            self.sampler = repeat_factor_training_sampler(labels, repeat_thresh, seed=seed)
        else:
            self.sampler = training_sampler(len(records), seed=seed)
        self.sampler2 = (training_sampler(len(self.records2), seed=seed + 1)
                         if self.records2 else None)
        self._rng = np.random.RandomState(seed + 7)

    def _sample_stream(self):
        """Yield (record, per-sample seed), mixing TRAIN2 at ratio2."""
        while True:
            if self.sampler2 is not None and self._rng.rand() < self.ratio2:
                rec = self.records2[next(self.sampler2)]
            else:
                rec = self.records[next(self.sampler)]
            yield rec, int(self._rng.randint(0, 2 ** 31 - 1))

    def __iter__(self):
        stream = self._sample_stream()
        lock = threading.Lock()
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH_BATCHES * self.batch_size)
        stop = threading.Event()

        def put_checking_stop(item) -> bool:
            """Bounded put that re-checks stop — a worker must not block
            forever on a full queue after the consumer stopped pulling
            (abandoned iterator / exception propagated out of the yield)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        rec, seed = next(stream)
                    except StopIteration:
                        return
                try:
                    sample = self.mapper(rec, np.random.RandomState(seed))
                except Exception as e:  # noqa: BLE001 — surfaced to the consumer via the queue
                    put_checking_stop(e)
                    return
                if not put_checking_stop(sample):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                batch = []
                while len(batch) < self.batch_size:
                    item = out_q.get()
                    if isinstance(item, Exception):
                        raise item
                    batch.append(item)
                yield collate(batch)
        finally:
            # each worker ends after the sample it is mapping: a thread left
            # inside a torch call would abort the interpreter's exit
            stop.set()
            for t in threads:
                t.join()
