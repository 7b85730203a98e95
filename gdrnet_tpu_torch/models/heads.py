"""Geometry head and translation head, NCHW (counterpart of
gdrnet_tpu/models/heads.py).

RotWithRegionHead: the 8x8 backbone feature -> 64x64 maps laid out as
[mask | xyz | region] on the channel axis. One stride-2 ConvTranspose, then
`num_layers` rounds of (x2 bilinear upsample, skipped in round 0) + 2 convs,
then a 1x1 out conv. The modules sit in one ModuleList `features` in the
reference's order, so the state-dict keys are `features.<idx>`. With
`concat` (ROT_CONCAT) each round first concatenates a backbone skip (16, 32,
then 64 px) and always upsamples, so every round has an upsample slot and the
maps come out at 128x128, as in the JAX package (heads.py:80-86: no shipped
reference config enables it, and the 64x64 ground truth does not match it).

TransHeadNet: the CDPN direct-translation head that R_ONLY reads: 3 x
(conv 3x3, BN, ReLU) as `features`, then flatten (C, H, W) and fc1, fc2
(ReLU) and fc3 -> 3, in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gdrnet_tpu_torch.models.layers import (
    UpsampleBilinear2x,
    conv_norm_act,
    deconv_2x,
    get_norm,
)


class RotWithRegionHead(nn.Module):
    def __init__(self, in_channels: int, rot_output_dim: int = 3,
                 mask_output_dim: int = 1, region_output_dim: int = 9,
                 num_layers: int = 3, num_filters: int = 256, kernel_size: int = 3,
                 output_kernel_size: int = 1, norm: str = "BN",
                 num_gn_groups: int = 32, num_classes: int = 1,
                 rot_class_aware: bool = False, mask_class_aware: bool = False,
                 region_class_aware: bool = False, concat_channels: tuple[int, ...] = ()):
        super().__init__()
        self.concat = bool(concat_channels)
        self.rot_output_dim = rot_output_dim
        self.mask_output_dim = mask_output_dim
        self.region_output_dim = region_output_dim
        self.num_classes = num_classes
        self.rot_class_aware = rot_class_aware
        self.mask_class_aware = mask_class_aware
        self.region_class_aware = region_class_aware

        feats: list[nn.Module] = [deconv_2x(in_channels, num_filters, kernel_size),
                                  get_norm(norm, num_filters, num_gn_groups),
                                  nn.ReLU(inplace=True)]
        self._concat_at: dict[int, int] = {}  # features index -> skip index (16, 32, 64 px)
        for i in range(num_layers):
            skip = concat_channels[i] if i < len(concat_channels) else 0
            if self.concat:
                self._concat_at[len(feats)] = i
            if i >= 1 or self.concat:
                feats.append(UpsampleBilinear2x())
            feats += conv_norm_act(num_filters + skip, num_filters, 3, 1, norm, num_gn_groups)
            feats += conv_norm_act(num_filters, num_filters, 3, 1, norm, num_gn_groups)
        feats.append(nn.Conv2d(num_filters, self.out_channels, output_kernel_size,
                               padding=output_kernel_size // 2, bias=True))
        self.features = nn.ModuleList(feats)

    @property
    def out_channels(self) -> int:
        m = self.num_classes if self.mask_class_aware else 1
        r = self.num_classes if self.rot_class_aware else 1
        g = self.num_classes if self.region_class_aware else 1
        return self.mask_output_dim * m + self.rot_output_dim * r + self.region_output_dim * g

    def forward(self, x: torch.Tensor, skips: tuple = ()) -> torch.Tensor:
        """[B, C, 8, 8] -> [B, out_channels, 64, 64] in f32; with concat,
        `skips` is (x_f16, x_f32, x_f64) and the maps are 128x128."""
        for idx, layer in enumerate(self.features[:-1]):
            if idx in self._concat_at:
                x = torch.cat([x, skips[self._concat_at[idx]].to(x.dtype)], dim=1)
            x = layer(x)
        # the out conv runs in f32 whatever autocast says (losses read it)
        with torch.autocast(x.device.type, enabled=False):
            return self.features[-1](x.float())

    def split_outputs(self, out: torch.Tensor, roi_classes: torch.Tensor | None = None):
        """[B, C, H, W] -> (mask, coor_x, coor_y, coor_z, region), each NCHW,
        with the class-aware gather where configured. Each coor_* has
        rot_output_dim // 3 channels."""
        b, _, h, w = out.shape

        def _gather(t, dim):
            if roi_classes is None:
                return t
            t = t.reshape(b, self.num_classes, dim, h, w)
            return t[torch.arange(b, device=t.device), roi_classes.long()]

        c = 0
        m_dim = self.mask_output_dim * (self.num_classes if self.mask_class_aware else 1)
        mask = out[:, c:c + m_dim]
        c += m_dim
        if self.mask_class_aware:
            mask = _gather(mask, self.mask_output_dim)

        r_dim = self.rot_output_dim * (self.num_classes if self.rot_class_aware else 1)
        xyz = out[:, c:c + r_dim]
        c += r_dim
        if self.rot_class_aware:
            xyz = _gather(xyz, self.rot_output_dim)
        nbin = self.rot_output_dim // 3
        coor_x, coor_y, coor_z = xyz[:, :nbin], xyz[:, nbin:2 * nbin], xyz[:, 2 * nbin:3 * nbin]

        g_dim = self.region_output_dim * (self.num_classes if self.region_class_aware else 1)
        region = out[:, c:c + g_dim]
        if self.region_class_aware:
            region = _gather(region, self.region_output_dim)
        return mask, coor_x, coor_y, coor_z, region


class TransHeadNet(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 3, num_filters: int = 256,
                 kernel_size: int = 3, norm: str = "BN", num_gn_groups: int = 32,
                 out_channel: int = 3, flat_hw: int = 8 * 8):
        super().__init__()
        feats: list[nn.Module] = []
        for i in range(num_layers):
            feats += conv_norm_act(in_channels if i == 0 else num_filters, num_filters,
                                   kernel_size, 1, norm, num_gn_groups)
        self.features = nn.ModuleList(feats)
        self.fc1 = nn.Linear(num_filters * flat_hw, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, 8, 8] -> [B, 3] in f32."""
        for layer in self.features:
            x = layer(x)
        with torch.autocast(x.device.type, enabled=False):
            x = x.flatten(1).float()
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            return self.fc3(x)
