"""DCGAN-style transposed-convolution decoder.

Port of shotvae_tpu/models/decoder.py:21-54: a ConvTranspose from the
(B, latent) sample to ``16*num_feature`` channels at ``img_size/32``
resolution, four ConvTranspose(k4, s2, p1) + BN + ReLU stages halving the
channels 1024->512->256->128->64, and a final ConvTranspose to
``num_channel`` with no activation: the decoder emits logits.

``decoder`` keeps the reference Sequential's indices (ConvTranspose at 0, 3,
..., 15, BatchNorm at 1, 4, ..., 13; the ReLUs at 2, 5, ... hold no
parameters and are fused into the BatchNorms, which run with slope 0: the
``bn_act`` kernel in eval mode, the ``bn_leaky`` kernels in train mode).
The JAX package's subpixel split of the stride-2 ConvTranspose is a TPU
workaround and is not ported: these are native ``ConvTranspose2d``, run by
the library (cuDNN on the card) as the JAX package leaves them to XLA, in
the compute ``dtype`` (None: float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from shotvae_torch.models.layers import (RELU_SLOPE, BatchNorm, channels_last,
                                         conv)


class Decoder(nn.Module):
    def __init__(self, latent_dim: int, num_channel: int = 3,
                 num_feature: int = 64, kernel_size: Tuple[int, int] = (1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        feats = [num_feature * 16, num_feature * 8, num_feature * 4,
                 num_feature * 2, num_feature]
        layers = {"0": nn.ConvTranspose2d(latent_dim, feats[0], kernel_size,
                                          bias=False),
                  "1": BatchNorm(feats[0], RELU_SLOPE, dtype)}
        for i in range(1, len(feats)):
            layers[str(3 * i)] = nn.ConvTranspose2d(feats[i - 1], feats[i], 4,
                                                    stride=2, padding=1,
                                                    bias=False)
            layers[str(3 * i + 1)] = BatchNorm(feats[i], RELU_SLOPE, dtype)
        layers["15"] = nn.ConvTranspose2d(num_feature, num_channel, 4,
                                          stride=2, padding=1, bias=False)
        self.decoder = nn.ModuleDict(layers)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, D) latent -> (B, num_channel, H, W) logits, in ``dtype``."""
        x = channels_last(latent[:, :, None, None])
        d = self.decoder
        for i in range(5):
            x = d[str(3 * i + 1)](conv(d[str(3 * i)], x, self.dtype))
        return conv(d["15"], x, self.dtype)
