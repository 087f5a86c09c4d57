"""Shared building blocks. Port of shotvae_tpu/models/layers.py:26-153.

* Init: torch's default weight init for Conv2d / ConvTranspose2d / Linear
  (kaiming_uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in))) with ZERO biases,
  the JAX package's documented deviation 4 (README "Parity and documented
  deviations").
* ``BatchNorm``: BatchNorm2d (eps 1e-5) with the activation that follows it
  at every site of the model, LeakyReLU(0.01) or ReLU (slope 0). In eval
  mode its running statistics are folded into one per-channel scale/shift,
  applied by the ``bn_act`` kernel alone or as the prologue of the
  ``fused_conv`` kernel. Train mode is the training slice and raises.
* Activations are NCHW tensors in ``channels_last`` memory format, whose
  memory is the (N*H*W, C) rows the kernels take.
"""

from __future__ import annotations

import torch
from torch import nn

from shotvae_torch.ops.kernels.bn_act import bn_act_inference
from shotvae_torch.ops.kernels.fused_conv import (bn_affine_from_stats,
                                                  fused_bn_act_conv)

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope
RELU_SLOPE = 0.0
_TRAIN_SLICE = ("train-mode BatchNorm is not ported yet: it is the training "
                "slice (ROADMAP.md queue 1 item 4, queue 2 bn_leaky_train); "
                "call .eval() to serve")


def zero_biases_(module: nn.Module) -> nn.Module:
    """Keep torch's default weight init, zero every conv/linear bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                and m.bias is not None:
            nn.init.zeros_(m.bias)
    return module


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d followed by LeakyReLU(``slope``) (ReLU for slope 0)."""

    def __init__(self, num_features: int, slope: float = LEAKY_SLOPE):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.slope = slope

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(_TRAIN_SLICE)

    def scale_shift(self):
        """The eval-mode affine, folded from the running statistics."""
        return bn_affine_from_stats(self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """act(BN(x)) through the ``bn_act`` kernel."""
        self._check_eval()
        x = channels_last(x)
        n, c, h, w = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
        y = bn_act_inference(rows, self.weight, self.bias, self.running_mean,
                             self.running_var, self.eps, self.slope)
        return y.reshape(n, h, w, c).permute(0, 3, 1, 2)

    def act_conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        """conv(act(BN(x))) for a 3x3 stride-1 bias-free ``conv``, through
        the ``fused_conv`` kernel."""
        self._check_eval()
        if conv.stride != (1, 1) or conv.padding != (1, 1) \
                or conv.bias is not None:
            raise ValueError("act_conv fuses only a 3x3, stride-1, "
                             "padding-1, bias-free conv")
        scale, shift = self.scale_shift()
        return fused_bn_act_conv(channels_last(x), scale, shift, conv.weight,
                                 slope=self.slope)
