"""Pre-activation ResNet-18/34/50/101/152 encoders. Port of
shotvae_tpu/models/preactresnet.py:19-114.

Basic (expansion 1) and bottleneck (expansion 4) pre-activation units in
four groups that double the width, stride 2 at unit 1 of groups 2 to 4,
then a final BN+ReLU transition. Every activation is a ReLU (slope 0).
Parameter paths are the reference's
(``encoder.block{k}.preact_block.unit{i}.{f_block.norm1..3,conv1..3,
i_block.norm,i_block.conv}``, ``encoder.transition.norm``), the names
``shotvae_tpu/io/torch_export.py`` emits, so an exported state_dict loads
with ``strict=True``.

Kernel sites, as in the WideResNet: every stride-1 BN->ReLU->conv3x3 is a
fused conv site (``BatchNorm.act_conv``); a BN->ReLU before a stride-2 3x3
conv or a 1x1 conv, and the transition, are standalone BN sites. The
projection shortcut (when the stride or the width changes) is BN with no
activation, then a strided 1x1 conv (the reference comments its ReLU out):
a standalone BN site with slope 1, which every kernel computes as the
identity exactly. At preactresnet18 that is 13 fused sites, 4 standalone
BN+ReLU sites and 3 identity BN sites per forward.

``drop_rate`` drops the output of the unit's stride-carrying 3x3 conv in
train mode (conv1 of a basic unit, conv2 of a bottleneck), as the JAX unit
does, with the masks of one device generator per forward.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
from torch import nn

from shotvae_torch.models.layers import (IDENTITY_SLOPE, RELU_SLOPE,
                                         BatchNorm, conv, dropout)
from shotvae_torch.models.wideresnet import PreProcess
from shotvae_torch.ops.sampling import device_generator


class PreActUnit(nn.Module):
    """Basic: BN->ReLU->conv3x3(stride)->dropout->BN->ReLU->conv3x3.
    Bottleneck: BN->ReLU->conv1x1->BN->ReLU->conv3x3(stride)->dropout->
    BN->ReLU->conv1x1(4x). Plus BN->conv1x1(stride) on the shortcut where
    the shape changes."""

    def __init__(self, in_features: int, features: int, expansion: int = 1,
                 stride: int = 1, dtype: Optional[torch.dtype] = None,
                 drop_rate: float = 0.0):
        super().__init__()
        self.expansion = expansion
        self.stride = stride
        self.dtype = dtype
        self.drop_rate = drop_rate
        out_features = features * expansion

        def norm(c, slope=RELU_SLOPE):
            return BatchNorm(c, slope=slope, dtype=dtype)

        def conv3x3(cin, stride_=1):
            return nn.Conv2d(cin, features, 3, stride=stride_, padding=1,
                             bias=False)

        def conv1x1(cin, cout, stride_=1):
            return nn.Conv2d(cin, cout, 1, stride=stride_, bias=False)

        if expansion == 1:
            layers = OrderedDict(norm1=norm(in_features),
                                 conv1=conv3x3(in_features, stride),
                                 norm2=norm(features),
                                 conv2=conv3x3(features))
        else:
            layers = OrderedDict(norm1=norm(in_features),
                                 conv1=conv1x1(in_features, features),
                                 norm2=norm(features),
                                 conv2=conv3x3(features, stride),
                                 norm3=norm(features),
                                 conv3=conv1x1(features, out_features))
        self.f_block = nn.ModuleDict(layers)
        self.i_block = None
        if stride != 1 or in_features != out_features:
            self.i_block = nn.ModuleDict(OrderedDict(
                norm=norm(in_features, IDENTITY_SLOPE),
                conv=conv1x1(in_features, out_features, stride)))

    def _norm_conv(self, norm: BatchNorm, layer: nn.Conv2d, x):
        """conv(act(BN(x))): the fused site for a stride-1 3x3 conv, else a
        standalone BN site and the library's conv."""
        if layer.kernel_size == (3, 3) and layer.stride == (1, 1):
            return norm.act_conv(x, layer)
        return conv(layer, norm(x), self.dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` (on x's device) draws the dropout mask in train
        mode."""
        f = self.f_block
        h = self._norm_conv(f.norm1, f.conv1, x)
        if self.expansion != 1:
            h = self._norm_conv(f.norm2, f.conv2, h)
        if self.training and self.drop_rate > 0:
            h = dropout(h, self.drop_rate, generator)
        if self.expansion == 1:
            h = self._norm_conv(f.norm2, f.conv2, h)
        else:
            h = self._norm_conv(f.norm3, f.conv3, h)
        if self.i_block is not None:
            x = self._norm_conv(self.i_block.norm, self.i_block.conv, x)
        return h + x


class PreActResNet(nn.Module):
    """The encoder trunk; emits (B, 8 * expansion * num_init_features, H/8,
    W/8) features for 32x32 inputs (``small_input``) and four groups."""

    def __init__(self, expansion: int = 1,
                 block_config: Sequence[int] = (2, 2, 2, 2),
                 num_init_features: int = 64, num_input_channels: int = 3,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                 small_input: bool = True):
        super().__init__()
        self.drop_rate = drop_rate
        self.num_feature_channel = (num_init_features
                                    * 2 ** (len(block_config) - 1)
                                    * expansion)
        blocks = OrderedDict(pre_process=PreProcess(
            num_input_channels, num_init_features, small_input, dtype))
        cin, features = num_init_features, num_init_features
        for group, depth in enumerate(block_config, start=1):
            units = OrderedDict()
            for i in range(1, depth + 1):
                stride = 2 if (group > 1 and i == 1) else 1
                units[f"unit{i}"] = PreActUnit(cin, features, expansion,
                                               stride, dtype, drop_rate)
                cin = features * expansion
            blocks[f"block{group}"] = nn.ModuleDict(
                {"preact_block": nn.Sequential(units)})
            features *= 2
        blocks["transition"] = nn.ModuleDict({"norm": BatchNorm(
            self.num_feature_channel, slope=RELU_SLOPE, dtype=dtype)})
        self.encoder = nn.ModuleDict(blocks)
        self.groups = len(block_config)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (a host generator; None: torch's default) seeds
        the dropout masks where dropout acts."""
        gen = (device_generator(generator, x.device)
               if self.training and self.drop_rate > 0 else None)
        x = self.encoder.pre_process(x)
        for group in range(1, self.groups + 1):
            for unit in self.encoder[f"block{group}"].preact_block:
                x = unit(x, gen)
        return self.encoder.transition.norm(x)


preactresnet_dict = {
    "preactresnet18": {"expansion": 1, "block_config": (2, 2, 2, 2)},
    "preactresnet34": {"expansion": 1, "block_config": (3, 4, 6, 3)},
    "preactresnet50": {"expansion": 4, "block_config": (3, 4, 6, 3)},
    "preactresnet101": {"expansion": 4, "block_config": (3, 4, 23, 3)},
    "preactresnet152": {"expansion": 4, "block_config": (3, 8, 36, 3)},
}
