"""Shared building blocks (counterpart of gdrnet_tpu/models/layers.py).

The port runs NCHW inside its modules. Flax's BatchNorm momentum 0.9 (the
weight of the old running value) is torch's momentum 0.1 (the weight of the
new batch value).

BatchNorm under data parallelism: the JAX package's comment says its BN
keeps per-replica statistics (gdrnet_tpu/models/layers.py:21-28), but its
train step is one jit over the global batch sharded on the `data` axis
(gdrnet_tpu/engine/steps.py:101-124), so flax BN's mean over the batch axis
is a global reduction there. The port computes what that program computes:
under a process group of more than one rank, engine/trainer.py swaps every
BatchNorm2d for parallel/sync_bn.SyncBatchNorm2d, whose batch statistics,
running statistics and precise-BN averages are those of the global batch.
The reference normalises per GPU (ROADMAP.md §C). DropBlock likewise draws
the global batch's seeds and keeps the rank's rows (its `shard`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def get_norm(norm: str, num_channels: int, num_gn_groups: int = 32) -> nn.Module:
    """BN / GN / none, with the JAX package's eps 1e-5."""
    if norm in ("BN", "SyncBN"):
        return nn.BatchNorm2d(num_channels, eps=1e-5, momentum=0.1)
    if norm == "GN":
        return nn.GroupNorm(num_gn_groups, num_channels, eps=1e-5)
    if norm in ("none", ""):
        return nn.Identity()
    raise ValueError(f"Unknown norm type: {norm}")


class UpsampleBilinear2x(nn.Module):
    """x2 bilinear upsample with align_corners=True (torch's UpsamplingBilinear2d).

    Under CUDA autocast the input is cast to f32 here, as autocast itself
    casts upsample_bilinear2d's input in an eager forward (its CPU rule
    keeps bf16). torch.export retraces the op as upsample_bilinear2d.vec,
    which autocast leaves in bf16, so without the explicit cast an exported
    program's upsample is a bf16 op one ulp off the eager forward's f32 one
    (and an int8 layer after it rounds some inputs the other way)."""

    def forward(self, x):
        if x.is_cuda and torch.is_autocast_enabled("cuda"):
            x = x.float()
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def dropblock(x: torch.Tensor, seed_mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """DropBlock's deterministic core: grow each seed of the [B, 1, H, W]
    0/1 mask to a block_size square (a stride-1 max-pool with SAME padding),
    drop those pixels of x and rescale by the kept share (floored at 1e-6)."""
    lo = (block_size - 1) // 2
    hi = block_size - 1 - lo
    # the mask is 0 or 1, so zero padding pools like flax's -inf padding
    block = F.max_pool2d(F.pad(seed_mask, (lo, hi, lo, hi)), block_size, stride=1)
    keep = 1.0 - block
    return x * keep / keep.mean(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)


class DropBlock2D(nn.Module):
    """DropBlock with the reference's LinearScheduler folded in: the drop
    probability ramps from 0 to drop_prob as `progress` goes from 0 to 1.
    At train time the seeds are a Bernoulli draw with gamma = drop_prob *
    clip(progress, 0, 1) / block_size^2 from `generator` (on x's device).
    `shard` = (data rank, data ranks), set by parallel/mesh.ddp_model,
    draws for the global batch (every rank's generator has the same seed)
    and keeps the rank's row block, so that N ranks drop what one process
    at the global batch drops (model peers, which hold the same rows, draw
    the same)."""

    def __init__(self, drop_prob: float = 0.0, block_size: int = 5):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size
        self.shard = (0, 1)

    def forward(self, x: torch.Tensor, progress: float = 1.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        gamma = self.drop_prob * min(max(progress, 0.0), 1.0) / self.block_size ** 2
        b, _, h, w = x.shape
        rank, world = self.shard
        draw = torch.rand((b * world, 1, h, w), generator=generator,
                          device=x.device)[rank * b:(rank + 1) * b]
        return dropblock(x, (draw < gamma).to(x.dtype), self.block_size)


def conv_norm_act(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                  norm: str = "BN", num_gn_groups: int = 32) -> list[nn.Module]:
    """Counterpart of the JAX package's ConvNormAct: [conv, norm, ReLU] as
    three modules, the way the reference's ModuleLists hold them (so the
    state_dict keys index them)."""
    return [nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=False),
            get_norm(norm, out_ch, num_gn_groups), nn.ReLU(inplace=True)]


def deconv_2x(in_ch: int, out_ch: int, kernel_size: int = 3) -> nn.ConvTranspose2d:
    """Stride-2 transposed conv that doubles H and W; padding and
    output_padding per kernel size as in gdrnet_tpu/models/heads.py:62."""
    pad, out_pad = {2: (0, 0), 3: (1, 1), 4: (1, 0)}[kernel_size]
    return nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=2, padding=pad,
                              output_padding=out_pad, bias=False)
