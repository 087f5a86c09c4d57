"""WideResNet-d-w encoder. Port of shotvae_tpu/models/wideresnet.py:21-116.

Pre-activation BN->LeakyReLU->conv3x3 residual units in 3 groups of widths
(16w, 32w, 64w), (d-4)/6 units each, stride 2 at the first unit of groups 2
and 3, then a final BN+LeakyReLU transition. Parameter paths are the
reference's (``encoder.wideblock{k}.wide_block.wideunit{i}.{f,i}_block.*``),
so an exported reference state_dict loads with ``strict=True``.

Kernel sites, the same in both modes: every stride-1 BN->act->conv3x3 is a
fused conv site (``fused_conv``: its kernel, behind the ``bn_leaky``
statistics in train mode); a BN->act before a stride-2 conv or a 1x1
shortcut, and the transition, are standalone BN sites (``bn_leaky`` in train
mode, ``bn_act`` in eval mode). At WRN-28-2 that is 22 fused and 6
standalone sites per forward.

``dtype`` (None: float32) is the trunk's compute dtype, as the JAX
package's ``dtype``: every conv, BN output and residual add is in it; the
image is cast by the stem conv.

``drop_rate`` (the CLI's ``-dr``) drops conv1's output of every unit in
train mode, before norm2, as flax's ``Dropout`` does there; the masks come
from one device generator per forward, seeded by one draw from the
caller's host generator. At the default 0 the forward draws nothing and
adds no op.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from shotvae_torch.models.layers import BatchNorm, conv, dropout, max_pool
from shotvae_torch.ops.sampling import device_generator

NUM_INIT_FEATURES = 16  # conv0's width


class PreProcess(nn.Module):
    """The stem (shotvae_tpu/models/wideresnet.py:21-40): a 3x3 stride-1
    conv for 32x32 inputs (``small_input``), otherwise a 7x7 stride-2 conv
    and a 3x3 stride-2 max pool."""

    def __init__(self, in_channels: int,
                 num_init_features: int = NUM_INIT_FEATURES,
                 small_input: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.small_input = small_input
        self.conv0 = (nn.Conv2d(in_channels, num_init_features, 3, padding=1)
                      if small_input else
                      nn.Conv2d(in_channels, num_init_features, 7, stride=2,
                                padding=3))

    def forward(self, x):
        x = conv(self.conv0, x, self.dtype)
        return x if self.small_input else max_pool(x)


class WideResUnit(nn.Module):
    """BN->LeakyReLU->conv3x3->dropout->BN->LeakyReLU->conv3x3 (+
    BN->LeakyReLU->1x1 shortcut from the pre-activation input when channels
    or stride change)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.f_block = nn.ModuleDict(OrderedDict(
            norm1=BatchNorm(in_features, dtype=dtype),
            conv1=nn.Conv2d(in_features, features, 3, stride=stride,
                            padding=1, bias=False),
            norm2=BatchNorm(features, dtype=dtype),
            conv2=nn.Conv2d(features, features, 3, padding=1, bias=False)))
        self.i_block = None
        if in_features != features or stride != 1:
            self.i_block = nn.ModuleDict(OrderedDict(
                norm=BatchNorm(in_features, dtype=dtype),
                conv=nn.Conv2d(in_features, features, 1, stride=stride,
                               bias=False)))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` (on x's device) draws the dropout mask in train
        mode."""
        f = self.f_block
        if self.stride == 1:
            h = f.norm1.act_conv(x, f.conv1)
        else:
            h = conv(f.conv1, f.norm1(x), self.dtype)
        if self.training and self.drop_rate > 0:
            h = dropout(h, self.drop_rate, generator)
        h = f.norm2.act_conv(h, f.conv2)
        if self.i_block is not None:
            x = conv(self.i_block.conv, self.i_block.norm(x), self.dtype)
        return h + x


def wrn_units(depth: int, width: int, num_input_channels: int = 3,
              dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
              small_input: bool = True) -> "OrderedDict[str, nn.Module]":
    """The trunk's stem and its three groups of units, under the reference's
    names (``pre_process``, ``wideblock{k}.wide_block.wideunit{i}``), in
    order; the caller adds the final BN+LeakyReLU where its layout puts
    it."""
    if (depth - 4) % 6:
        raise ValueError(f"depth should be 6n+4, got {depth}")
    block_depth = (depth - 4) // 6
    blocks = OrderedDict(pre_process=PreProcess(
        num_input_channels, small_input=small_input, dtype=dtype))
    cin = NUM_INIT_FEATURES
    for group, features in enumerate((16 * width, 32 * width, 64 * width),
                                     start=1):
        units = OrderedDict()
        for i in range(1, block_depth + 1):
            stride = 2 if (group > 1 and i == 1) else 1
            units[f"wideunit{i}"] = WideResUnit(cin, features, stride, dtype,
                                                drop_rate)
            cin = features
        blocks[f"wideblock{group}"] = nn.ModuleDict(
            {"wide_block": nn.Sequential(units)})
    return blocks


def run_units(blocks: nn.ModuleDict, x: torch.Tensor, generator=None,
              drop: bool = False) -> torch.Tensor:
    """The stem and every unit of ``blocks`` (``wrn_units``' modules) on
    ``x``. With ``drop``, one device generator seeded by one draw from
    ``generator`` (a host generator; None: torch's default) draws every
    unit's dropout mask."""
    gen = device_generator(generator, x.device) if drop else None
    x = blocks.pre_process(x)
    for group in (1, 2, 3):
        for unit in blocks[f"wideblock{group}"].wide_block:
            x = unit(x, gen)
    return x


class WideResNet(nn.Module):
    """The encoder trunk; emits (B, 64w, H/4, W/4) features for 32x32
    inputs (``small_input``)."""

    def __init__(self, depth: int = 28, width: int = 2,
                 num_input_channels: int = 3,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                 small_input: bool = True):
        super().__init__()
        self.drop_rate = drop_rate
        self.num_feature_channel = 64 * width
        blocks = wrn_units(depth, width, num_input_channels, dtype, drop_rate,
                           small_input)
        blocks["transition"] = nn.ModuleDict({"norm": BatchNorm(
            self.num_feature_channel, dtype=dtype)})
        self.encoder = nn.ModuleDict(blocks)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (a host generator; None: torch's default) seeds
        the dropout masks where dropout acts."""
        x = run_units(self.encoder, x, generator,
                      self.training and self.drop_rate > 0)
        return self.encoder.transition.norm(x)


def parse_wideresnet_name(name: str) -> tuple[int, int]:
    """'wideresnet-28-2' -> (28, 2)."""
    depth, width = re.findall(r"\d+", name)
    return int(depth), int(width)
