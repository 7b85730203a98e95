"""Samplers (a copy of gdrnet_tpu/data/samplers.py, which cannot be imported
without JAX): infinite shuffled / repeat-factor / sharded inference index
streams (reference core/utils/my_distributed_sampler.py:12-200). Each is a
plain generator over indices; the `shard`/`num_shards` arguments reproduce
the rank::world_size striding of the reference's distributed samplers
(:43-45) for multi-host TPU data loading.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter

import numpy as np


def training_sampler(n: int, shard: int = 0, num_shards: int = 1,
                     shuffle: bool = True, seed: int = 0):
    """Infinite stream of dataset indices, reshuffled every epoch, strided
    by shard (TrainingSampler, my_distributed_sampler.py:12-54)."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        yield from order[shard::num_shards].tolist()


def repeat_factors_from_category_frequency(labels: list, repeat_thresh: float) -> np.ndarray:
    """Per-instance repeat factor r_i = max(1, sqrt(T / f_c)) (reference
    RepeatFactorTrainingSampler._get_repeat_factors, :83-120)."""
    counts = Counter(labels)
    n = len(labels)
    cat_freq = {c: cnt / n for c, cnt in counts.items()}
    cat_rep = {c: max(1.0, math.sqrt(repeat_thresh / f)) for c, f in cat_freq.items()}
    return np.asarray([cat_rep[l] for l in labels], np.float64)


def repeat_factor_training_sampler(labels: list, repeat_thresh: float,
                                   shard: int = 0, num_shards: int = 1,
                                   seed: int = 0):
    """Class-balanced infinite sampler: instances repeat by ceil/floor of
    their repeat factor with stochastic rounding per epoch (reference
    :122-169)."""
    rep = repeat_factors_from_category_frequency(labels, repeat_thresh)
    frac = rep - np.floor(rep)
    rng = np.random.RandomState(seed)
    n = len(labels)
    while True:
        rounded = np.floor(rep) + (rng.rand(n) < frac)
        indices = np.repeat(np.arange(n), rounded.astype(np.int64))
        order = rng.permutation(len(indices))
        yield from indices[order][shard::num_shards].tolist()


def inference_sampler(n: int, shard: int = 0, num_shards: int = 1):
    """One pass, contiguous shards (InferenceSampler, :172-200)."""
    per = -(-n // num_shards)
    start = shard * per
    return iter(range(start, min(start + per, n)))


def batched(iterator, batch_size: int):
    """Group an index stream into fixed-size batches (drop_last semantics of
    my_build_batch_data_loader, core/utils/dataset_utils.py:183-234)."""
    it = iter(iterator)
    while True:
        batch = list(itertools.islice(it, batch_size))
        if len(batch) < batch_size:
            return
        yield batch
