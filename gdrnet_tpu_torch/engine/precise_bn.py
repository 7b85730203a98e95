"""Precise BN: recompute the BatchNorm running statistics as a true average
over N training batches before an evaluation (counterpart of
gdrnet_tpu/engine/precise_bn.py; the reference's TEST.PRECISE_BN, fvcore's
update_bn_stats).

Each batch's statistics come straight from torch's BatchNorm with
momentum=None, its cumulative average, in a train-mode forward under
no_grad. BatchNorms that stay in eval mode there (a frozen module's, see
models/gdrn.py) keep theirs. torch's running_var is the average of the
unbiased batch variances; the JAX package averages flax's biased ones, so
the two differ by n / (n - 1), n the layer's B*H*W.

Under a process group the model's BatchNorms are parallel/sync_bn.
SyncBatchNorm2d (engine/trainer.py), whose batch statistics are the global
batch's: every rank averages the same statistics over the same number of
batches, as the JAX package's precise BN over its sharded batch does
(gdrnet_tpu/engine/precise_bn.py:16-47), and every rank must call this
with the same num_iters. The statistics are the data group's (model peers
see the same rows; parallel/sync_bn.py), and on a model axis the sharded
layers gather in the forward, so every model peer calls this too.
"""

from __future__ import annotations

import itertools
from typing import Iterable

import torch
import torch.nn as nn


@torch.no_grad()
def update_bn_stats(model: nn.Module, batches: Iterable[dict], num_iters: int = 200,
                    forward=None) -> int:
    """Replace the running statistics of every BatchNorm that is in train
    mode in model.train() by their average over the first `num_iters`
    batches; forward(model, batch) runs one (default: model(**batch)).
    Returns the number of batches averaged (0 leaves the model as it was).
    The model's mode, the momenta and the batch counts are restored."""
    was_training = model.training
    model.train()
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
           and m.training and m.track_running_stats]
    if not bns:
        model.train(was_training)
        return 0
    saved = [(m.momentum, m.num_batches_tracked.clone(), m.running_mean.clone(),
              m.running_var.clone()) for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # the cumulative average over the batches seen
    n = 0
    try:
        for batch in itertools.islice(batches, num_iters):
            if forward is None:
                model(**batch)
            else:
                forward(model, batch)
            n += 1
    finally:
        for m, (momentum, count, mean, var) in zip(bns, saved):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)
            if n == 0:
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
        model.train(was_training)
    return n
