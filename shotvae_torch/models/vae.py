"""The SHOT-VAE composition. Port of shotvae_tpu/models/vae.py:31-124.

encoder -> global average pool -> three linear heads (z mean, z log-sigma,
y log-alpha via log-softmax), all f32 -> [z ; y] sample -> DCGAN decoder.
The heads' products take bfloat16 operands and float32 sums
(``layers.HeadLinear``), as the JAX package's float32 heads compute on a
TPU at XLA's default precision.
Parameter paths are the reference's (``feature_extractor``,
``continuous_inference.{mean,log_sigma}.fc``, ``disc_latent_inference.fc``,
``feature_reconstructor``), the names ``shotvae_tpu/io/torch_export.py``
emits, so an exported checkpoint loads with ``strict=True``.

Train mode (``module.train()``) normalises with batch statistics through the
``bn_leaky`` kernels and draws the latent with the differentiable
``sampling.joint_latent``, as the JAX train step does; eval mode serves
through the eval kernels and the ``fused_sample`` kernel, which has no
gradient. Methods take and return NCHW tensors; the serving API
(``shotvae_torch.api``) keeps the JAX package's NHWC layout.

The encoder is any of the JAX package's families (``build_encoder``):
``WideResNet``, ``PreActResNet`` or ``DenseNet`` (with ``efficient``, its
block recomputation), each with the stem ``small_input`` picks; its
``num_feature_channel`` sizes the heads. ``drop_rate`` is the encoder's
train-mode dropout, seeded from the same host generator as the latent
draw.

``dtype`` (None: float32, as in JAX) is the trunk's compute dtype, as
``VariationalAutoEncoder(dtype=jnp.bfloat16)``: the encoder and decoder
compute in it; the pooled features are pooled in it and then cast to f32
for the heads, which, the sampler and the parameters stay f32; the latent
is cast to it before the decoder, whose logits come back as f32
(shotvae_tpu/models/vae.py:92-105).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shotvae_torch.device import DeviceLike, resolve_device
from shotvae_torch.models.decoder import Decoder
from shotvae_torch.models.densenet import DenseNet, densenet_dict
from shotvae_torch.models.layers import (HeadLinear, channels_last,
                                         global_avg_pool, zero_biases_)
from shotvae_torch.models.preactresnet import PreActResNet, preactresnet_dict
from shotvae_torch.models.wideresnet import WideResNet, parse_wideresnet_name
from shotvae_torch.ops import sampling
from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample


def build_encoder(encoder_name: str, *, num_input_channels: int = 3,
                  dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                  small_input: bool = True,
                  efficient: bool = False) -> nn.Module:
    """Resolve an encoder by name, as shotvae_tpu/models/vae.py:30-60: a
    ``densenet_dict`` or ``preactresnet_dict`` key, or
    'wideresnet-<depth>-<width>'. ``efficient`` is DenseNet's block
    recomputation; the other families take no such option."""
    kw = dict(num_input_channels=num_input_channels, dtype=dtype,
              drop_rate=drop_rate, small_input=small_input)
    if "densenet" in encoder_name:
        return DenseNet(**densenet_dict[encoder_name], efficient=efficient,
                        **kw)
    if "wideresnet" in encoder_name:
        depth, width = parse_wideresnet_name(encoder_name)
        return WideResNet(depth, width, **kw)
    if "preactresnet" in encoder_name:
        return PreActResNet(**preactresnet_dict[encoder_name], **kw)
    raise NotImplementedError(f"{encoder_name} not implemented")


def _linear_head(in_features: int, out_features: int) -> nn.ModuleDict:
    return nn.ModuleDict({"fc": HeadLinear(in_features, out_features)})


class VariationalAutoEncoder(nn.Module):
    def __init__(self, encoder_name: str = "wideresnet-28-2",
                 num_input_channels: int = 3,
                 img_size: Tuple[int, int] = (32, 32),
                 continuous_latent_dim: int = 128, disc_latent_dim: int = 10,
                 sample_temperature: float = 0.67,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                 small_input: bool = True, efficient: bool = False):
        super().__init__()
        self.dtype = dtype
        self.continuous_latent_dim = continuous_latent_dim
        self.disc_latent_dim = disc_latent_dim
        self.sample_temperature = sample_temperature
        self.feature_extractor = build_encoder(
            encoder_name, num_input_channels=num_input_channels, dtype=dtype,
            drop_rate=drop_rate, small_input=small_input, efficient=efficient)
        feat = self.feature_extractor.num_feature_channel
        self.continuous_inference = nn.ModuleDict(OrderedDict(
            mean=_linear_head(feat, continuous_latent_dim),
            log_sigma=_linear_head(feat, continuous_latent_dim)))
        self.disc_latent_inference = _linear_head(feat, disc_latent_dim)
        self.feature_reconstructor = Decoder(
            continuous_latent_dim + disc_latent_dim,
            num_channel=num_input_channels,
            kernel_size=(img_size[0] // 32, img_size[1] // 32), dtype=dtype)
        zero_biases_(self)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """(B, C, H, W) f32 -> (mean, log_sigma, log_alpha), all f32.
        ``generator`` seeds the encoder's dropout in train mode."""
        features = self.feature_extractor(channels_last(x), generator)
        avg = global_avg_pool(features).to(torch.float32)  # pooled in dtype
        ci = self.continuous_inference
        norm_mean = ci.mean.fc(avg)
        norm_log_sigma = ci.log_sigma.fc(avg)
        disc_log_alpha = F.log_softmax(self.disc_latent_inference.fc(avg),
                                       dim=1)
        return norm_mean, norm_log_sigma, disc_log_alpha

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, Dc + Dd) latent -> (B, C, H, W) reconstruction logits, f32."""
        return self.feature_reconstructor(
            latent.to(self.dtype or torch.float32)).to(torch.float32)

    def forward(self, x: torch.Tensor, *, labels=None, mixup: bool = False,
                labels_mixup=None, mixup_lam=None, noise: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """-> (reconstruction logits, mean, log_sigma, log_alpha), as
        shotvae_tpu/models/vae.py:107-124.

        ``labels`` replace the discrete draw with their one-hots (-1 rows
        keep the draw); with ``mixup`` the one-hots of ``labels`` and
        ``labels_mixup`` are combined with weight ``mixup_lam``. In train
        mode, or with labels or ``noise`` ({"eps", "unif"}, injected draws
        for deterministic replay against the JAX model), the latent comes
        from the differentiable ``sampling.joint_latent``. Otherwise (eval
        mode, no labels, no noise) the ``fused_sample`` kernel draws it.
        Either draw is seeded by one draw from ``generator``, which does
        not synchronise the card where ``generator`` is a host generator.
        """
        norm_mean, norm_log_sigma, disc_log_alpha = self.encode(x, generator)
        if self.training or labels is not None or noise is not None:
            latent = sampling.joint_latent(
                norm_mean, norm_log_sigma, disc_log_alpha,
                self.sample_temperature, labels=labels,
                labels_mixup=labels_mixup if mixup else None,
                mixup_lam=mixup_lam if mixup else None, noise=noise,
                generator=(None if generator is None else
                           sampling.device_generator(generator,
                                                     norm_mean.device)))
        else:
            latent = fused_joint_sample(norm_mean, norm_log_sigma,
                                        disc_log_alpha,
                                        self.sample_temperature,
                                        generator=generator)
        recon = self.decode(latent)
        return recon, norm_mean, norm_log_sigma, disc_log_alpha
