"""BatchNorm over the global batch of every rank (the counterpart of the
JAX package's BN under GSPMD: its train step is one program over the
global batch sharded on the `data` axis, gdrnet_tpu/engine/steps.py:101-124,
so flax BN's batch mean and variance are global reductions).

The batch is split over the data group (parallel/multihost.py): on a grid
with a model axis, model peers hold the same rows, so the statistics are
reduced over the data group alone (a sum over the whole world would count
each row m times, m the model axis's ranks).

SyncBatchNorm2d is an nn.BatchNorm2d whose train-mode forward normalises by
the statistics of the batch of every rank: the per-channel count and sum,
then the sum of squared deviations from the global mean, each all-reduced
over the data group; its backward all-reduces the per-channel
sums of dy and dy * x_hat. Its running statistics update as torch's BN
updates them (momentum, or the cumulative average with momentum None, and
the unbiased variance over the global count), so every rank holds the same
buffers. In eval mode, with running statistics, or without a data group of
more than one rank, it is the plain BN.

It uses all_reduce alone, so it runs on NCCL and on gloo, on the card and
on the CPU (torch.nn.SyncBatchNorm needs CUDA tensors). Plain PyTorch: it
ports no TPU kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from gdrnet_tpu_torch.parallel import multihost as mh

_DIMS = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _SyncBatchNormFn(torch.autograd.Function):
    """y = (x - mean) * invstd * w + b over the global batch; the statistics
    and the backward's sums in f32, y in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        local = torch.cat([xf.new_full((1,), xf.numel() // xf.shape[1]), xf.sum(_DIMS)])
        dist.all_reduce(local, group=group)
        count, mean = local[0], local[1:] / local[0]
        centred = xf - _per_channel(mean)
        sq = centred.square().sum(_DIMS)
        dist.all_reduce(sq, group=group)
        invstd = torch.rsqrt(sq / count + eps)
        x_hat = centred * _per_channel(invstd)
        y = x_hat * _per_channel(weight) + _per_channel(bias) if weight is not None else x_hat
        ctx.save_for_backward(x_hat, invstd, weight, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, sq, count)
        return y.to(x.dtype), mean, sq, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dsq, _dcount):
        x_hat, invstd, weight, count = ctx.saved_tensors
        dyf = dy.float()
        sums = torch.cat([dyf.sum(_DIMS), (dyf * x_hat).sum(_DIMS)])
        local_db, local_dw = sums.clone().chunk(2)
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xhat = sums.chunk(2)
        scale = invstd if weight is None else invstd * weight.float()
        dx = _per_channel(scale) * (dyf - _per_channel(sum_dy / count)
                                    - x_hat * _per_channel(sum_dy_xhat / count))
        # the affine parameters' gradients stay local: DDP averages them
        dw = local_dw.to(weight.dtype) if weight is not None and ctx.needs_input_grad[1] else None
        db = local_db.to(weight.dtype) if weight is not None and ctx.needs_input_grad[2] else None
        return dx.to(dy.dtype), dw, db, None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with global batch statistics under a data group of
    more than one rank (module docstring); the same parameters, buffers and
    state_dict keys."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        use_batch = self.training or self.running_mean is None
        if not use_batch or mh.data_size() == 1:
            return super().forward(x)
        y, mean, sq, count = _SyncBatchNormFn.apply(x, self.weight, self.bias, self.eps,
                                                    mh.data_group())
        if self.training and self.track_running_stats:
            with torch.no_grad():  # torch's update (its batch_norm_update_stats)
                self.num_batches_tracked.add_(1)
                f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                     else self.momentum)
                unbiased = sq / (count - 1).clamp_min(1.0)
                for buf, new in ((self.running_mean, mean), (self.running_var, unbiased)):
                    buf.copy_(f * new + (1.0 - f) * buf)
        return y


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Swap every nn.BatchNorm2d of `model` for a SyncBatchNorm2d holding the
    same parameter and buffer tensors (so an optimizer built before or after
    sees the same parameters, and the state_dict keys are kept), in place;
    returns `model`. Each keeps its train / eval mode."""
    for name, child in list(model.named_children()):
        if type(child) is nn.BatchNorm2d:
            sync = SyncBatchNorm2d(child.num_features, eps=child.eps, momentum=child.momentum,
                                   affine=child.affine,
                                   track_running_stats=child.track_running_stats,
                                   device="meta")
            for pname, p in child.named_parameters(recurse=False):
                setattr(sync, pname, p)
            for bname, b in child.named_buffers(recurse=False):
                sync.register_buffer(bname, b)
            sync.train(child.training)
            setattr(model, name, sync)
        else:
            convert_sync_bn(child)
    return model
