"""ResNet backbone, NCHW (counterpart of gdrnet_tpu/models/resnet.py).

State-dict keys follow torchvision's ResNet (conv1, bn1, layerN.i.convK /
bnK, layerN.i.downsample.{0,1}), the layout of the reference's checkpoints.
Depths 18 and 34 stack BasicBlocks; 50, 101 and 152 stack Bottlenecks (1x1,
3x3 with the stride, 1x1 to 4x the width), so their last stage has 2048
channels.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# depth -> (block, stage sizes, stage widths)
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2), (64, 128, 256, 512)),
    34: ("basic", (3, 4, 6, 3), (64, 128, 256, 512)),
    50: ("bottleneck", (3, 4, 6, 3), (64, 128, 256, 512)),
    101: ("bottleneck", (3, 4, 23, 3), (64, 128, 256, 512)),
    152: ("bottleneck", (3, 8, 36, 3), (64, 128, 256, 512)),
}


def stage_channels(depth: int) -> tuple[int, ...]:
    """The channels of each stage's output, as the heads see them."""
    block, _, widths = RESNET_SPEC[depth]
    return tuple(w * (4 if block == "bottleneck" else 1) for w in widths)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = _bn(width)
        self.downsample = _downsample(in_ch, width, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = _bn(width * 4)
        self.downsample = _downsample(in_ch, width * 4, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNetBackbone(nn.Module):
    """x [B, 3, 256, 256] -> the stride-32 feature [B, C, 8, 8]; with
    rot_concat, also the 64/32/16 skips (layers 1-3): (x_high, x_f64,
    x_f32, x_f16)."""

    def __init__(self, depth: int = 34, rot_concat: bool = False):
        super().__init__()
        if depth not in RESNET_SPEC:
            raise ValueError(f"Unknown ResNet depth {depth}; one of {sorted(RESNET_SPEC)}")
        block_name, stages, widths = RESNET_SPEC[depth]
        block = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.rot_concat = rot_concat
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for si, (n_blocks, width) in enumerate(zip(stages, widths)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(in_ch, width, 2 if (si > 0 and bi == 0) else 1))
                in_ch = width * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x_f64 = self.layer1(x)
        x_f32 = self.layer2(x_f64)
        x_f16 = self.layer3(x_f32)
        x_high = self.layer4(x_f16)
        return (x_high, x_f64, x_f32, x_f16) if self.rot_concat else x_high
