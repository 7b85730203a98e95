"""PVNet-style dense net: a dilated ResNet trunk at output stride 8 and a
skip decoder emitting confidence and coordinate maps at the input's
resolution (counterpart of gdrnet_tpu/models/pvnet.py:1-141).

The reference is the vendored pvnet_net (core/gdrn_modeling/models/
pvnet_net/model_repository.py:7-95 Resnet18_8s, :221 Resnet34_8s; the
dilated trunk resnet.py:17-45,121-207). As the JAX package, depths 18 and
34 (basic blocks): the stem halves twice (conv, max pool), stages 1-2 as
ResNet's, stages 3 and 4 at stride 1 with dilation 2 and 4, so the trunk
ends at stride 8. The decoder concatenates the skips at strides 8, 4, 2 and
1 (the raw input), each round a conv, BN and LeakyReLU(0.1), with a x2
bilinear upsample at half-pixel centres between them (the JAX package's
jax.image.resize: F.interpolate with align_corners=False, not the
align-corners UpsamplingBilinear2d of the GDRN heads). A 1x1 head splits its
channels by (conf_mode, coor_mode) as model_repository.py:74-95: "cls"
confidence is 2 channels, "reg" 1; "cls" coordinates NUM_BINS each axis,
"reg" 1.

NCHW inside; the input and the four outputs are NHWC, as the JAX module's.
The BNs are flax's default (momentum 0.99, eps 1e-5), which is torch
momentum 0.01. State-dict keys follow the reference's layout:
resnet{depth}_8s.{conv1, bn1, layerN.i.convK / bnK / downsample.{0,1},
fc.{0,1}}, conv8s / conv4s / conv2s / convraw.{0,1} and head;
utils/jax_convert.pvnet_jax_to_torch carries the JAX module's variables.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gdrnet_tpu_torch.models.resnet import RESNET_SPEC

BN_MOMENTUM = 0.01  # flax nn.BatchNorm's default momentum 0.99
LEAKY_SLOPE = 0.1
# each stage's (width, stride, dilation): stride 8 at the end
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=BN_MOMENTUM)


class DilatedBasicBlock(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, d, dilation=d, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, d, dilation=d, bias=False)
        self.bn2 = _bn(width)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, width, 1, stride, bias=False),
                                         _bn(width))
                           if in_ch != width or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class DilatedResNet8s(nn.Module):
    """x [B, 3, H, W] -> (x2s, x4s, x8s, the trunk's last stage at /8)."""

    def __init__(self, depth: int, fcdim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for si, ((width, stride, dil), n_blocks) in enumerate(zip(STAGES, RESNET_SPEC[depth][1])):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(DilatedBasicBlock(in_ch, width, stride if bi == 0 else 1, dil))
                in_ch = width
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.fc = nn.Sequential(nn.Conv2d(in_ch, fcdim, 3, 1, 1, bias=False), _bn(fcdim),
                                nn.ReLU())

    def forward(self, x: torch.Tensor):
        x2s = torch.relu(self.bn1(self.conv1(x)))
        x4s = self.layer1(self.maxpool(x2s))
        x8s = self.layer2(x4s)
        return x2s, x4s, x8s, self.fc(self.layer4(self.layer3(x8s)))


def _conv_bn_act(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=False), _bn(out_ch),
                         nn.LeakyReLU(LEAKY_SLOPE))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear at half-pixel centres, in f32 and cast back (jax.image.resize)."""
    return F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                         align_corners=False).to(x.dtype)


class PVNet(nn.Module):
    """NHWC input [B, H, W, 3] -> (conf, coor_x, coor_y, coor_z), each
    [B, H, W, channels] in f32. conf_mode and coor_mode in {"cls", "reg"}
    select the channel split (model_repository.py:74-95)."""

    def __init__(self, depth: int = 18, conf_mode: str = "cls", coor_mode: str = "cls",
                 num_bins: int = 65, fcdim: int = 256, s8dim: int = 128, s4dim: int = 64,
                 s2dim: int = 32, raw_dim: int = 32):
        super().__init__()
        if depth not in (18, 34):
            raise ValueError("PVNet trunk supports depth 18/34 (basic blocks)")
        self.depth = depth
        self.n_conf = 2 if conf_mode == "cls" else 1
        self.n_coor = num_bins if coor_mode == "cls" else 1
        setattr(self, f"resnet{depth}_8s", DilatedResNet8s(depth, fcdim))
        self.conv8s = _conv_bn_act(fcdim + 128, s8dim)
        self.conv4s = _conv_bn_act(s8dim + 64, s4dim)
        self.conv2s = _conv_bn_act(s4dim + 64, s2dim)
        self.convraw = _conv_bn_act(s2dim + 3, raw_dim)
        self.head = nn.Conv2d(raw_dim, self.n_conf + 3 * self.n_coor, 1)

    def forward(self, x: torch.Tensor):
        raw = x.permute(0, 3, 1, 2)
        x2s, x4s, x8s, xfc = getattr(self, f"resnet{self.depth}_8s")(raw)
        fm = _up2(self.conv8s(torch.cat([xfc, x8s], 1)))
        fm = _up2(self.conv4s(torch.cat([fm, x4s], 1)))
        fm = _up2(self.conv2s(torch.cat([fm, x2s], 1)))
        fm = self.convraw(torch.cat([fm, raw.to(fm.dtype)], 1))
        out = self.head(fm).float().permute(0, 2, 3, 1)
        c, n = self.n_conf, self.n_coor
        return out[..., :c], out[..., c:c + n], out[..., c + n:c + 2 * n], out[..., c + 2 * n:]
