"""DenseNet-BC encoders, with block-level recomputation. Port of
shotvae_tpu/models/densenet.py:21-136.

Bottleneck dense layers (BN->ReLU->conv1x1->BN->ReLU->conv3x3) whose
``growth_rate`` new channels are concatenated to their input, transitions
(BN->ReLU->conv1x1 compressing by ``compression``->2x2 average pool)
between the blocks, and a final BN+ReLU. Parameter paths are the
reference's (``encoder.denseblock{b}.denselayer{l}.{norm1,conv1,norm2,
conv2}``, ``encoder.transition{b}.{norm,conv}``), the names
``shotvae_tpu/io/torch_export.py`` emits: the final BN is the reference's
last transition, ``encoder.transition{n}.norm`` for n blocks (JAX's
``final_norm``), so an exported state_dict loads with ``strict=True``.

Kernel sites: a dense layer's norm1+ReLU is a standalone BN site before
the library's 1x1 conv; its norm2+ReLU+conv3x3 is a fused conv site, from
``bn_size * growth_rate`` channels to ``growth_rate``. The transitions and
the final BN are standalone BN sites. At densenet121 that is 58 fused and
62 standalone sites per forward. The concatenation keeps the
``channels_last`` format, so no site converts its input.

``efficient`` recomputes each whole dense block in the backward, as the
JAX package's ``nn.remat`` around each ``DenseBlock`` does (per-layer
recomputation kept more memory live, docs/PERF.md "DenseNet memory
study"): ``torch.utils.checkpoint`` (non-reentrant) keeps only the block's
input. Two things of a JAX remat that a checkpoint does not give are made
explicit: the recompute leaves the running statistics alone (a BN site
tracks them once, in the forward; ``layers.recomputing``), and it replays
the forward's dropout masks, restoring the device generator to its state
at the block's start (the checkpoint's own ``preserve_rng_state`` restores
only torch's default generators, which the trunk does not draw from). The
recompute launches each block's forward kernels once more in the backward.
In eval mode, or with no gradient, a block runs as it is.

``drop_rate`` drops each dense layer's new channels in train mode, after
its 3x3 conv, as the JAX layer does, with the masks of one device
generator per forward.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import nullcontext
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from shotvae_torch.models.layers import (RELU_SLOPE, BatchNorm, avg_pool,
                                         conv, dropout, recomputing)
from shotvae_torch.models.wideresnet import PreProcess
from shotvae_torch.ops.sampling import device_generator


def _norm(c: int, dtype) -> BatchNorm:
    return BatchNorm(c, slope=RELU_SLOPE, dtype=dtype)


class DenseLayer(nn.Module):
    """BN->ReLU->conv1x1 (``bn_size * growth_rate``)->BN->ReLU->conv3x3
    (``growth_rate``)->dropout: the layer's new channels."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 4,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        mid = bn_size * growth_rate
        self.norm1 = _norm(in_features, dtype)
        self.conv1 = nn.Conv2d(in_features, mid, 1, bias=False)
        self.norm2 = _norm(mid, dtype)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = conv(self.conv1, self.norm1(x), self.dtype)
        h = self.norm2.act_conv(h, self.conv2)
        if self.training and self.drop_rate > 0:
            h = dropout(h, self.drop_rate, generator)
        return h


class DenseBlock(nn.ModuleDict):
    """``num_layers`` dense layers, each fed the concatenation of the
    block's input and every earlier layer's new channels."""

    def __init__(self, num_layers: int, in_features: int, growth_rate: int,
                 bn_size: int = 4, dtype: Optional[torch.dtype] = None,
                 drop_rate: float = 0.0):
        super().__init__(OrderedDict(
            (f"denselayer{i + 1}",
             DenseLayer(in_features + i * growth_rate, growth_rate, bn_size,
                        dtype, drop_rate))
            for i in range(num_layers)))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for layer in self.values():
            # cat of channels_last inputs stays channels_last
            x = torch.cat([x, layer(x, generator)], dim=1)
        return x


def _replayed(block: DenseBlock, x, generator, state):
    """``block`` on x, the device generator first set to ``state`` (its
    state at the block's start in the forward), so a recompute draws the
    forward's dropout masks."""
    if generator is not None:
        generator.set_state(state)
    return block(x, generator)


def _recompute_contexts():
    """torch.utils.checkpoint's ``context_fn``: nothing around the forward,
    ``layers.recomputing`` around the recompute."""
    return nullcontext(), recomputing()


class DenseNet(nn.Module):
    """The encoder trunk; emits (B, num_feature_channel, H / 2^(blocks - 1),
    W / 2^(blocks - 1)) features for 32x32 inputs (``small_input``)."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 16, compression: float = 0.5,
                 bn_size: int = 4, num_input_channels: int = 3,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                 efficient: bool = False, small_input: bool = True):
        super().__init__()
        self.drop_rate = drop_rate
        self.efficient = efficient
        self.num_blocks = len(block_config)
        blocks = OrderedDict(pre_process=PreProcess(
            num_input_channels, num_init_features, small_input, dtype))
        n = num_init_features
        for i, num_layers in enumerate(block_config, start=1):
            blocks[f"denseblock{i}"] = DenseBlock(num_layers, n, growth_rate,
                                                  bn_size, dtype, drop_rate)
            n += num_layers * growth_rate
            if i != self.num_blocks:
                out = int(n * compression)
                blocks[f"transition{i}"] = nn.ModuleDict(OrderedDict(
                    norm=_norm(n, dtype),
                    conv=nn.Conv2d(n, out, 1, bias=False)))
                n = out
        blocks[f"transition{self.num_blocks}"] = nn.ModuleDict(
            {"norm": _norm(n, dtype)})
        self.num_feature_channel = n
        self.dtype = dtype
        self.encoder = nn.ModuleDict(blocks)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (a host generator; None: torch's default) seeds
        the dropout masks where dropout acts."""
        gen = (device_generator(generator, x.device)
               if self.training and self.drop_rate > 0 else None)
        recompute = self.efficient and self.training \
            and torch.is_grad_enabled()
        x = self.encoder.pre_process(x)
        for i in range(1, self.num_blocks + 1):
            block = self.encoder[f"denseblock{i}"]
            if recompute:
                x = checkpoint(_replayed, block, x, gen,
                               None if gen is None else gen.get_state(),
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=_recompute_contexts)
            else:
                x = block(x, gen)
            trans = self.encoder[f"transition{i}"]
            if i != self.num_blocks:
                x = avg_pool(conv(trans.conv, trans.norm(x), self.dtype))
        return trans.norm(x)


densenet_dict = {
    "densenet121": {"growth_rate": 32, "block_config": (6, 12, 24, 16),
                    "num_init_features": 64},
    "densenet161": {"growth_rate": 48, "block_config": (6, 12, 36, 24),
                    "num_init_features": 96},
    "densenet169": {"growth_rate": 32, "block_config": (6, 12, 32, 32),
                    "num_init_features": 64},
    "densenet201": {"growth_rate": 32, "block_config": (6, 12, 48, 32),
                    "num_init_features": 64},
    "densenetbc100": {"growth_rate": 12, "block_config": (16, 16, 16),
                      "num_init_features": 24},
    "densenetbc250": {"growth_rate": 24, "block_config": (41, 41, 41),
                      "num_init_features": 48},
    "densenetbc190": {"growth_rate": 40, "block_config": (31, 31, 31),
                      "num_init_features": 40},
}
