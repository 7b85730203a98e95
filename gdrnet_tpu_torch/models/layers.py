"""Shared building blocks (counterpart of gdrnet_tpu/models/layers.py).

The port runs NCHW inside its modules. Flax's BatchNorm momentum 0.9 (the
weight of the old running value) is torch's momentum 0.1 (the weight of the
new batch value).
"""

from __future__ import annotations

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
    """x2 bilinear upsample with align_corners=True (torch's UpsamplingBilinear2d)."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


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
