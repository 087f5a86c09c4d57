"""Shared building blocks. Port of shotvae_tpu/models/layers.py:26-153.

* Init: torch's default weight init for Conv2d / ConvTranspose2d / Linear
  (kaiming_uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in))) with ZERO biases,
  the JAX package's documented deviation 4 (README "Parity and documented
  deviations").
* ``BatchNorm``: BatchNorm2d (eps 1e-5) with the activation that follows it
  at every site of the model, LeakyReLU(0.01), ReLU (slope 0) or none
  (slope 1, PreActResNet's projection shortcut: LeakyReLU(1) is the
  identity exactly, as every kernel computes it). In eval
  mode its running statistics are folded into one per-channel scale/shift,
  applied by the ``bn_act`` kernel alone or as the prologue of the
  ``fused_conv`` kernel. In train mode it normalises with the biased batch
  statistics through the ``bn_leaky`` kernels, alone or as the train-mode
  fused conv site, and updates its running statistics in place with
  momentum 0.1 from the BIASED batch variance, which is what flax tracks
  (the JAX package's README "Parity and documented deviations" 7; torch's
  own BatchNorm2d tracks the unbiased one).
* Activations are NCHW tensors in ``channels_last`` memory format, whose
  memory is the (N*H*W, C) rows the kernels take.
* Precision follows flax's ``dtype`` (not autocast): a module's ``dtype``
  is its compute dtype, None meaning the parameters' float32. ``conv``
  casts a conv's input, weight and bias to it on every call, as flax's
  ``promote_dtype`` does, so the f32 parameters keep their names and get
  f32 gradients through the cast. ``BatchNorm`` writes its output in its
  ``dtype``; its statistics, running statistics and parameters stay f32.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shotvae_torch.ops.kernels.bn_act import bn_act_inference
from shotvae_torch.ops.kernels.bn_leaky import bn_leaky_train
from shotvae_torch.ops.kernels.fused_conv import (bn_affine_from_stats,
                                                  from_rows,
                                                  fused_bn_act_conv,
                                                  fused_bn_act_conv_train,
                                                  to_rows)

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope
RELU_SLOPE = 0.0
IDENTITY_SLOPE = 1.0  # a BN site with no activation


_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """Inside, BN sites leave their running statistics alone: a
    checkpoint's recompute of a forward that already tracked them (in the
    thread that runs the recompute)."""
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def zero_biases_(module: nn.Module) -> nn.Module:
    """Keep torch's default weight init, zero every conv/linear bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                and m.bias is not None:
            nn.init.zeros_(m.bias)
    return module


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def conv(module: nn.Module, x: torch.Tensor,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``module`` (an ``nn.Conv2d`` or ``nn.ConvTranspose2d``) on ``x`` with
    the input, weight and bias cast to ``dtype`` (default: the weight's)."""
    dtype = dtype or module.weight.dtype
    w = module.weight.to(dtype)
    b = None if module.bias is None else module.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(module, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, module.stride, module.padding,
                                  module.output_padding, module.groups,
                                  module.dilation)
    return F.conv2d(x, w, b, module.stride, module.padding, module.dilation,
                    module.groups)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's train-mode ``Dropout``: each element is kept where a uniform
    draw on x's device lies below ``1 - rate`` and is then divided by
    ``1 - rate``, in x's dtype; the rest are 0. ``generator`` lives on x's
    device."""
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """flax's ``avg_pool(x, (2, 2), strides=(2, 2))``, in x's dtype and
    memory format: DenseNet's transition."""
    return F.avg_pool2d(x, 2)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax's ``max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1,
    1)))`` (padded with -inf): the large-input stem."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d followed by LeakyReLU(``slope``) (ReLU for slope 0, no
    activation for slope 1), with its output in ``dtype`` (None:
    float32)."""

    def __init__(self, num_features: int, slope: float = LEAKY_SLOPE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.slope = slope
        self.dtype = dtype or torch.float32

    def scale_shift(self):
        """The eval-mode affine, folded from the running statistics."""
        return bn_affine_from_stats(self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps)

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 * running + 0.1 * batch statistic (flax's
        momentum 0.9), in place; nothing inside ``recomputing``."""
        if getattr(_recompute, "active", False):
            return
        self.running_mean.mul_(1.0 - self.momentum).add_(mean,
                                                         alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var,
                                                        alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """act(BN(x)): the ``bn_leaky`` kernels in train mode, the ``bn_act``
        kernel in eval mode."""
        x = channels_last(x.to(self.dtype))
        n, _, h, w = x.shape
        rows = to_rows(x)
        if self.training:
            y, mean, var = bn_leaky_train(rows, self.weight, self.bias,
                                          self.eps, self.slope)
            self._track(mean, var)
        else:
            y = bn_act_inference(rows, self.weight, self.bias,
                                 self.running_mean, self.running_var,
                                 self.eps, self.slope)
        return from_rows(y, n, h, w)

    def act_conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        """conv(act(BN(x))) for a 3x3 stride-1 bias-free ``conv``, through
        the train-mode or the eval-mode fused conv site, in ``dtype`` (the
        sites cast the weight)."""
        if conv.stride != (1, 1) or conv.padding != (1, 1) \
                or conv.bias is not None:
            raise ValueError("act_conv fuses only a 3x3, stride-1, "
                             "padding-1, bias-free conv")
        x = channels_last(x.to(self.dtype))
        if self.training:
            y, mean, var = fused_bn_act_conv_train(
                x, self.weight, self.bias, conv.weight, eps=self.eps,
                slope=self.slope)
            self._track(mean, var)
            return y
        scale, shift = self.scale_shift()
        return fused_bn_act_conv(x, scale, shift, conv.weight,
                                 slope=self.slope)
