"""Patch-PnP: the learned PnP conv net, NCHW (counterpart of
gdrnet_tpu/models/conv_pnp_net.py).

Input: [xyz (denormalized by the extents when there are 3 or 5 coordinate
channels) | optional 2D coords | optional region attention | optional mask
attention] at 64x64; DropBlock at train time when drop_prob > 0; three
stride-2 convs (GN by default) down to 8x8;
flatten (C, H, W order) -> fc1 -> fc2 with LeakyReLU 0.1 -> fc_r and fc_t in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gdrnet_tpu_torch.models.layers import DropBlock2D, conv_norm_act


class ConvPnPNet(nn.Module):
    def __init__(self, in_channels: int, rot_dim: int = 6, featdim: int = 128,
                 num_layers: int = 3, norm: str = "GN", num_gn_groups: int = 32,
                 drop_prob: float = 0.0, dropblock_size: int = 5,
                 mask_attention_type: str = "none", flat_hw: int = 8 * 8):
        super().__init__()
        if mask_attention_type not in ("none", "mul", "concat"):
            raise ValueError(f"Wrong mask attention type: {mask_attention_type}")
        self.mask_attention_type = mask_attention_type
        self.dropblock = DropBlock2D(drop_prob, dropblock_size)
        feats: list[nn.Module] = []
        for i in range(num_layers):
            feats += conv_norm_act(in_channels if i == 0 else featdim, featdim, 3,
                                   2 if i < 3 else 1, norm, num_gn_groups)
        self.features = nn.ModuleList(feats)
        self.fc1 = nn.Linear(featdim * flat_hw, 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)

    def forward(self, coor_feat: torch.Tensor, region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None,
                dropblock_progress: float = 1.0, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """coor_feat [B,C,64,64] (xyz first when C is 3 or 5), region
        [B,R,64,64] attention, extents [B,3], mask_attention [B,1,64,64].
        DropBlock (train mode, drop_prob > 0) draws from `generator` at
        `dropblock_progress`. Returns (rot [B,rot_dim], t [B,3]) in f32."""
        if coor_feat.shape[1] in (3, 5):
            if extents is None:
                raise ValueError("ConvPnPNet: extents are needed to denormalize xyz")
            xyz = (coor_feat[:, :3] - 0.5) * extents[:, :, None, None]
            coor_feat = torch.cat([xyz, coor_feat[:, 3:]], dim=1)
        x = coor_feat if region is None else torch.cat([coor_feat, region], dim=1)
        if self.mask_attention_type == "mul":
            x = x * mask_attention
        elif self.mask_attention_type == "concat":
            x = torch.cat([x, mask_attention], dim=1)
        x = self.dropblock(x, dropblock_progress, generator)

        for layer in self.features:
            x = layer(x)
        x = x.flatten(1)
        x = F.leaky_relu(self.fc1(x), 0.1)
        x = F.leaky_relu(self.fc2(x), 0.1)
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            return self.fc_r(x), self.fc_t(x)
