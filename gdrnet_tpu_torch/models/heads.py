"""Geometry head, NCHW (counterpart of gdrnet_tpu/models/heads.py).

RotWithRegionHead: the 8x8 backbone feature -> 64x64 maps laid out as
[mask | xyz | region] on the channel axis. One stride-2 ConvTranspose, then
`num_layers` rounds of (x2 bilinear upsample, skipped in round 0) + 2 convs,
then a 1x1 out conv. The modules sit in one ModuleList `features` in the
reference's order, so the state-dict keys are `features.<idx>`.
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
                 region_class_aware: bool = False):
        super().__init__()
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
        for i in range(num_layers):
            if i >= 1:
                feats.append(UpsampleBilinear2x())
            feats += conv_norm_act(num_filters, num_filters, 3, 1, norm, num_gn_groups)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, 8, 8] -> [B, out_channels, 64, 64] in f32."""
        for layer in self.features[:-1]:
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
