"""ResNet backbone, NCHW (counterpart of gdrnet_tpu/models/resnet.py).

State-dict keys follow torchvision's ResNet (conv1, bn1, layerN.i.convK,
layerN.i.downsample.{0,1}), the layout of the reference's checkpoints.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# depth -> (stage sizes, stage widths); Bottleneck depths wait (ROADMAP A12)
RESNET_SPEC = {
    18: ((2, 2, 2, 2), (64, 128, 256, 512)),
    34: ((3, 4, 6, 3), (64, 128, 256, 512)),
}


def stage_channels(depth: int) -> tuple[int, ...]:
    return RESNET_SPEC[depth][1]


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNetBackbone(nn.Module):
    """x [B, 3, 256, 256] -> [B, 512, 8, 8] (stride 32)."""

    def __init__(self, depth: int = 34):
        super().__init__()
        if depth not in RESNET_SPEC:
            raise NotImplementedError(
                f"ResNet-{depth} (Bottleneck) is not ported yet (ROADMAP A12)")
        stages, widths = RESNET_SPEC[depth]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for si, (n_blocks, width) in enumerate(zip(stages, widths)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(BasicBlock(in_ch, width, 2 if (si > 0 and bi == 0) else 1))
                in_ch = width
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
