"""WideResNet-d-w encoder. Port of shotvae_tpu/models/wideresnet.py:21-116.

Pre-activation BN->LeakyReLU->conv3x3 residual units in 3 groups of widths
(16w, 32w, 64w), (d-4)/6 units each, stride 2 at the first unit of groups 2
and 3, then a final BN+LeakyReLU transition. Parameter paths are the
reference's (``encoder.wideblock{k}.wide_block.wideunit{i}.{f,i}_block.*``),
so an exported reference state_dict loads with ``strict=True``.

Kernel sites in eval mode: every stride-1 BN->act->conv3x3 runs the
``fused_conv`` kernel; a BN->act before a stride-2 conv or a 1x1 shortcut,
and the transition, run the ``bn_act`` kernel.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import torch
from torch import nn

from shotvae_torch.models.layers import BatchNorm

NUM_INIT_FEATURES = 16  # conv0's width


class PreProcess(nn.Module):
    """The stem for 32x32 inputs: a 3x3 stride-1 conv."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, NUM_INIT_FEATURES, 3, padding=1)

    def forward(self, x):
        return self.conv0(x)


class WideResUnit(nn.Module):
    """BN->LeakyReLU->conv3x3->BN->LeakyReLU->conv3x3 (+ BN->LeakyReLU->1x1
    shortcut from the pre-activation input when channels or stride
    change)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.f_block = nn.ModuleDict(OrderedDict(
            norm1=BatchNorm(in_features),
            conv1=nn.Conv2d(in_features, features, 3, stride=stride,
                            padding=1, bias=False),
            norm2=BatchNorm(features),
            conv2=nn.Conv2d(features, features, 3, padding=1, bias=False)))
        self.i_block = None
        if in_features != features or stride != 1:
            self.i_block = nn.ModuleDict(OrderedDict(
                norm=BatchNorm(in_features),
                conv=nn.Conv2d(in_features, features, 1, stride=stride,
                               bias=False)))

    def forward(self, x):
        f = self.f_block
        if self.stride == 1:
            h = f.norm1.act_conv(x, f.conv1)
        else:
            h = f.conv1(f.norm1(x))
        h = f.norm2.act_conv(h, f.conv2)
        if self.i_block is not None:
            x = self.i_block.conv(self.i_block.norm(x))
        return h + x


class WideResNet(nn.Module):
    """The encoder trunk; emits (B, 64w, H/4, W/4) features for 32x32
    inputs."""

    def __init__(self, depth: int = 28, width: int = 2,
                 num_input_channels: int = 3):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"depth should be 6n+4, got {depth}")
        block_depth = (depth - 4) // 6
        widths = [16 * width, 32 * width, 64 * width]
        self.num_feature_channel = widths[-1]
        blocks = OrderedDict(pre_process=PreProcess(num_input_channels))
        cin = NUM_INIT_FEATURES
        for group, features in enumerate(widths, start=1):
            units = OrderedDict()
            for i in range(1, block_depth + 1):
                stride = 2 if (group > 1 and i == 1) else 1
                units[f"wideunit{i}"] = WideResUnit(cin, features, stride)
                cin = features
            blocks[f"wideblock{group}"] = nn.ModuleDict(
                {"wide_block": nn.Sequential(units)})
        blocks["transition"] = nn.ModuleDict({"norm": BatchNorm(cin)})
        self.encoder = nn.ModuleDict(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.encoder
        x = e.pre_process(x)
        for group in (1, 2, 3):
            x = e[f"wideblock{group}"].wide_block(x)
        return e.transition.norm(x)


def parse_wideresnet_name(name: str) -> tuple[int, int]:
    """'wideresnet-28-2' -> (28, 2)."""
    depth, width = re.findall(r"\d+", name)
    return int(depth), int(width)
