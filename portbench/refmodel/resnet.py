"""ResNet bottom-up trunk (counterpart of ``u2seg_tpu/models/resnet.py``).

NCHW tensors in channels-last memory, so the FPN levels the pooler reads
are NHWC-contiguous. Module names follow detectron2
(``stem.conv1``, ``res2.0.conv1``, ``res2.0.shortcut``, each with ``.norm``).
``freeze_at = k`` freezes the stem (k >= 1) and the stages up to res{k}: they
stay in eval mode when the model trains and pass no gradient down.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.refmodel.config import ResNetConfig
from portbench.refmodel.layers import Conv2d, rounded
from portbench.refmodel.norms import get_norm

# depth -> blocks per stage
STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

FEATURE_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


class BasicStem(nn.Module):
    """7x7/2 conv + norm + relu + 3x3/2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int, norm: str):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, stride=2, padding=3,
                            bias=False, norm=get_norm(norm, out_channels))

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a residual."""

    def __init__(self, in_channels, out_channels, bottleneck_channels,
                 stride=1, stride_in_1x1=False, dilation=1, norm="SyncBN"):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride=stride,
                                   bias=False,
                                   norm=get_norm(norm, out_channels))
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1,
                            bias=False,
                            norm=get_norm(norm, bottleneck_channels))
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            stride=s3, padding=dilation, dilation=dilation,
                            bias=False,
                            norm=get_norm(norm, bottleneck_channels))
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False,
                            norm=get_norm(norm, out_channels))

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(rounded(self.conv3, out + shortcut))


class ResNet(nn.Module):
    """Staged ResNet returning {"res2".."res5"} feature maps."""

    def __init__(self, cfg: ResNetConfig, in_channels: int = 3):
        super().__init__()
        self.out_features = tuple(cfg.out_features)
        self.freeze_at = cfg.freeze_at
        self.stem = BasicStem(in_channels, cfg.stem_out_channels, cfg.norm)
        in_ch = cfg.stem_out_channels
        out_ch = cfg.res2_out_channels
        bott = cfg.num_groups * cfg.width_per_group
        self.stage_names = []
        for i, nblocks in enumerate(STAGE_BLOCKS[cfg.depth]):
            name = f"res{i + 2}"
            blocks = []
            for j in range(nblocks):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, bott,
                    stride=(1 if i == 0 else 2) if j == 0 else 1,
                    stride_in_1x1=cfg.stride_in_1x1, norm=cfg.norm,
                ))
                in_ch = out_ch
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_at >= 1:
            self.stem.eval()
        for i, name in enumerate(self.stage_names):
            if self.freeze_at >= i + 2:
                getattr(self, name).eval()
        return self

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        out = {}
        for i, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if self.freeze_at >= i + 2:
                x = x.detach()
            if name in self.out_features:
                out[name] = x
        return out


def feature_channels(cfg: ResNetConfig) -> Dict[str, int]:
    ch = cfg.res2_out_channels
    return {f"res{i + 2}": ch * (2 ** i) for i in range(4)}
