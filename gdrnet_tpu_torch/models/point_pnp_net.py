"""PointNet-style PnP heads (counterpart of gdrnet_tpu/models/point_pnp_net.py).

The ROI's pixels are points: a shared MLP (Linear layers named conv1-3, as
the JAX package's Dense layers over [B, N, C]) lifts each to 128 features.

PointPnPNet weights them by each region's softmax attention, [B, M, N, 128]
at once, and pools over the points per region (max, mean, top-k or SoftPool),
optionally SoftPools over the regions (region_softpool), then fc1, fc2
(LeakyReLU 0.1) and fc_r / fc_t in f32. It takes the mask attention and, as
the reference and the JAX package, does not apply it.

SimplePointPnPNet is the PointNet baseline: [coords | region | mask] per
point, the MLP, a global max pool (or SoftPool), fc1, fc2 and one fc_pose in
f32 whose first rot_dim outputs are the rotation and last 3 the translation.

Ties: torch.topk and jax.lax.top_k may order equal values differently, so
the gathered rows of soft_pool can differ on ties; gradients flow through
the gather.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def soft_pool(x: torch.Tensor, n_p: int = 32) -> torch.Tensor:
    """[B, N, F] -> [B, n_p, F, F]: for each channel f, the n_p points whose
    softmax over channels is largest at f, each its full feature row:
    out[b, k, :, f] = x[b, idx[b, f, k], :]."""
    b, _, f = x.shape
    idx = torch.topk(torch.softmax(x, dim=-1).transpose(1, 2), n_p, dim=-1).indices
    rows = x.gather(1, idx.reshape(b, f * n_p, 1).expand(b, f * n_p, f))
    return rows.reshape(b, f, n_p, f).permute(0, 2, 3, 1)


def topk_pool(x: torch.Tensor, k: int = 32) -> torch.Tensor:
    """[B, M, P, F] -> [B, M, k, F]: the top k of each feature over the points."""
    return torch.topk(x.transpose(-1, -2), k, dim=-1).values.transpose(-1, -2)


def _denormalize(coor_feat: torch.Tensor, extents: torch.Tensor | None) -> torch.Tensor:
    """The first 3 of 3 or 5 coordinate channels back to metric, (c - 0.5) * extent."""
    if coor_feat.shape[1] not in (3, 5):
        return coor_feat
    if extents is None:
        raise ValueError("the PnP head needs extents to denormalize xyz")
    xyz = (coor_feat[:, :3] - 0.5) * extents[:, :, None, None]
    return torch.cat([xyz, coor_feat[:, 3:]], dim=1)


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class PointPnPNet(nn.Module):
    def __init__(self, in_channels: int, rot_dim: int = 4, num_regions: int = 8,
                 spatial_pooltype: str = "max", spatial_topk: int = 1,
                 region_softpool: bool = False, region_topk: int = 8):
        super().__init__()
        if spatial_pooltype not in ("max", "mean", "topk", "soft"):
            raise ValueError(f"Unknown spatial pool type: {spatial_pooltype}")
        self.num_regions, self.spatial_pooltype = num_regions, spatial_pooltype
        self.spatial_topk, self.region_softpool, self.region_topk = (
            spatial_topk, region_softpool, region_topk)
        self.conv1 = nn.Linear(in_channels, 128)
        self.conv2 = nn.Linear(128, 128)
        self.conv3 = nn.Linear(128, 128)
        if spatial_pooltype == "topk":
            self.conv_topk = nn.Linear(spatial_topk * 128, 128)
        flat = num_regions * 128
        if region_softpool:
            self.conv_sp = nn.Linear(num_regions * num_regions, 128)
            flat = region_topk * 128
        self.fc1 = nn.Linear(flat, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)

    def forward(self, coor_feat: torch.Tensor, region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None,
                dropblock_progress: float = 1.0, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """coor_feat [B,C,H,W], region [B,M,H,W] softmax weights (needed).
        Returns (rot [B, rot_dim], t [B, 3]) in f32."""
        if region is None:
            raise ValueError("PointPnPNet weights the points by region: it needs "
                             "PNP_NET.REGION_ATTENTION")
        b, m = coor_feat.shape[0], self.num_regions
        x = _denormalize(coor_feat, extents).flatten(2).transpose(1, 2)  # [B, N, C]
        x = _act(self.conv1(x))
        x = _act(self.conv2(x))
        x = self.conv3(x)
        x = x[:, None] * region.flatten(2).to(x.dtype)[..., None]  # [B, M, N, 128]
        if self.spatial_pooltype == "max":
            x = x.amax(dim=2)
        elif self.spatial_pooltype == "mean":
            x = x.mean(dim=2)
        elif self.spatial_pooltype == "topk":
            x = _act(self.conv_topk(topk_pool(x, self.spatial_topk).reshape(b, m, -1)))
        else:
            sp = soft_pool(x.reshape(b * m, x.shape[2], 128), self.spatial_topk)
            x = sp.reshape(b, m, self.spatial_topk, 128, 128).amax(dim=(2, 4))
        if self.region_softpool:
            sp = soft_pool(x.transpose(1, 2), self.region_topk)  # [B, k, M, M]
            x = _act(self.conv_sp(sp.reshape(b, self.region_topk, -1)))
        x = _act(self.fc1(x.reshape(b, -1)))
        x = _act(self.fc2(x))
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            return self.fc_r(x), self.fc_t(x)


class SimplePointPnPNet(nn.Module):
    def __init__(self, in_channels: int, rot_dim: int = 6, use_softpool: bool = False,
                 softpool_topk: int = 32, mask_attention_type: str = "none"):
        super().__init__()
        if mask_attention_type not in ("none", "mul", "concat"):
            raise ValueError(f"Wrong mask attention type: {mask_attention_type}")
        self.rot_dim, self.use_softpool, self.softpool_topk = rot_dim, use_softpool, softpool_topk
        self.mask_attention_type = mask_attention_type
        self.conv1 = nn.Linear(in_channels, 128)
        self.conv2 = nn.Linear(128, 128)
        if use_softpool:
            self.conv3 = nn.Linear(128, 128)
            self.conv_sp = nn.Linear(128 * 128, 128)
            flat = softpool_topk * 128
        else:
            self.conv3 = nn.Linear(128, 1024)
            flat = 1024
        self.fc1 = nn.Linear(flat, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc_pose = nn.Linear(256, rot_dim + 3)

    def forward(self, coor_feat: torch.Tensor, region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None,
                dropblock_progress: float = 1.0, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """coor_feat [B,C,H,W], region [B,M,H,W] or None, mask_attention
        [B,1,H,W]. Returns (rot [B, rot_dim], t [B, 3]) in f32."""
        b = coor_feat.shape[0]
        x = _denormalize(coor_feat, extents)
        if region is not None:
            x = torch.cat([x, region.to(x.dtype)], dim=1)
        if self.mask_attention_type == "mul":
            x = x * mask_attention
        elif self.mask_attention_type == "concat":
            x = torch.cat([x, mask_attention.to(x.dtype)], dim=1)
        x = x.flatten(2).transpose(1, 2)  # [B, N, C]
        x = _act(self.conv1(x))
        x = _act(self.conv2(x))
        if self.use_softpool:
            sp = soft_pool(self.conv3(x), self.softpool_topk)  # [B, k, 128, 128]
            x = _act(self.conv_sp(sp.reshape(b, self.softpool_topk, -1))).reshape(b, -1)
        else:
            x = self.conv3(x).amax(dim=1)  # PointNet's global max pool
        x = _act(self.fc1(x))
        x = _act(self.fc2(x))
        with torch.autocast(x.device.type, enabled=False):
            pose = self.fc_pose(x.float())
        return pose[:, :self.rot_dim], pose[:, self.rot_dim:]
