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

Init: each ConvTranspose weight is U(+-1/sqrt(fan_in)) with the JAX
package's fan_in, its input channels times the kernel area
(shotvae_tpu/models/layers.py:TorchConvTranspose, flax's variance scaling
over the kernel's input-channel axis). torch's default takes the output
channels instead, which draws the logits layer (64 -> 3) 4.6x wider, the
four k4 s2 layers sqrt(2)x wider and the first (Dc + Dd -> 1024) 2.7x
narrower than the JAX model.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from shotvae_torch.models.layers import (RELU_SLOPE, BatchNorm, channels_last,
                                         conv)


def conv_transpose(cin: int, cout: int, kernel_size, *, bias: bool = False,
                   **kw) -> nn.ConvTranspose2d:
    """A ``ConvTranspose2d`` (bias-free unless ``bias``) whose weight takes
    the JAX package's init law; a bias is drawn by torch's law, which
    ``layers.zero_biases_`` then zeroes."""
    layer = nn.ConvTranspose2d(cin, cout, kernel_size, bias=bias, **kw)
    kh, kw_ = layer.kernel_size
    bound = 1.0 / math.sqrt(cin * kh * kw_)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound)
    return layer


class Decoder(nn.Module):
    def __init__(self, latent_dim: int, num_channel: int = 3,
                 num_feature: int = 64, kernel_size: Tuple[int, int] = (1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        feats = [num_feature * 16, num_feature * 8, num_feature * 4,
                 num_feature * 2, num_feature]
        layers = {"0": conv_transpose(latent_dim, feats[0], kernel_size),
                  "1": BatchNorm(feats[0], RELU_SLOPE, dtype)}
        for i in range(1, len(feats)):
            layers[str(3 * i)] = conv_transpose(feats[i - 1], feats[i], 4,
                                                stride=2, padding=1)
            layers[str(3 * i + 1)] = BatchNorm(feats[i], RELU_SLOPE, dtype)
        layers["15"] = conv_transpose(num_feature, num_channel, 4, stride=2,
                                      padding=1)
        self.decoder = nn.ModuleDict(layers)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, D) latent -> (B, num_channel, H, W) logits, in ``dtype``."""
        x = channels_last(latent[:, :, None, None])
        d = self.decoder
        for i in range(5):
            x = d[str(3 * i + 1)](conv(d[str(3 * i)], x, self.dtype))
        return conv(d["15"], x, self.dtype)
