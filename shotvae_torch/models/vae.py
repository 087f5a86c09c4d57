"""The SHOT-VAE composition. Port of shotvae_tpu/models/vae.py:31-124.

encoder -> global average pool -> three linear heads (z mean, z log-sigma,
y log-alpha via log-softmax), all f32 -> [z ; y] sample -> DCGAN decoder.
Parameter paths are the reference's (``feature_extractor``,
``continuous_inference.{mean,log_sigma}.fc``, ``disc_latent_inference.fc``,
``feature_reconstructor``), the names ``shotvae_tpu/io/torch_export.py``
emits, so an exported checkpoint loads with ``strict=True``.

Eval mode only in this slice (``module.eval()``); a train-mode forward
raises ``NotImplementedError``. Methods take and return NCHW tensors; the
serving API (``shotvae_torch.api``) keeps the JAX package's NHWC layout.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shotvae_torch.device import DeviceLike, resolve_device
from shotvae_torch.models.decoder import Decoder
from shotvae_torch.models.layers import (channels_last, global_avg_pool,
                                         zero_biases_)
from shotvae_torch.models.wideresnet import WideResNet, parse_wideresnet_name
from shotvae_torch.ops import sampling
from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample


def build_encoder(encoder_name: str, *,
                  num_input_channels: int = 3) -> nn.Module:
    """Resolve an encoder by name; the port has the WideResNet so far."""
    if "wideresnet" in encoder_name:
        depth, width = parse_wideresnet_name(encoder_name)
        return WideResNet(depth, width, num_input_channels=num_input_channels)
    raise NotImplementedError(
        f"{encoder_name} is not ported yet (ROADMAP.md queue 1 item 9: "
        "PreActResNet and DenseNet encoders)")


def _linear_head(in_features: int, out_features: int) -> nn.ModuleDict:
    return nn.ModuleDict({"fc": nn.Linear(in_features, out_features)})


class VariationalAutoEncoder(nn.Module):
    def __init__(self, encoder_name: str = "wideresnet-28-2",
                 num_input_channels: int = 3,
                 img_size: Tuple[int, int] = (32, 32),
                 continuous_latent_dim: int = 128, disc_latent_dim: int = 10,
                 sample_temperature: float = 0.67,
                 device: DeviceLike = None):
        super().__init__()
        self.continuous_latent_dim = continuous_latent_dim
        self.disc_latent_dim = disc_latent_dim
        self.sample_temperature = sample_temperature
        self.feature_extractor = build_encoder(
            encoder_name, num_input_channels=num_input_channels)
        feat = self.feature_extractor.num_feature_channel
        self.continuous_inference = nn.ModuleDict(OrderedDict(
            mean=_linear_head(feat, continuous_latent_dim),
            log_sigma=_linear_head(feat, continuous_latent_dim)))
        self.disc_latent_inference = _linear_head(feat, disc_latent_dim)
        self.feature_reconstructor = Decoder(
            continuous_latent_dim + disc_latent_dim,
            num_channel=num_input_channels,
            kernel_size=(img_size[0] // 32, img_size[1] // 32))
        zero_biases_(self)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    def encode(self, x: torch.Tensor):
        """(B, C, H, W) f32 -> (mean, log_sigma, log_alpha), all f32."""
        features = self.feature_extractor(channels_last(x))
        avg = global_avg_pool(features).to(torch.float32)
        ci = self.continuous_inference
        norm_mean = ci.mean.fc(avg)
        norm_log_sigma = ci.log_sigma.fc(avg)
        disc_log_alpha = F.log_softmax(self.disc_latent_inference.fc(avg),
                                       dim=1)
        return norm_mean, norm_log_sigma, disc_log_alpha

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, Dc + Dd) latent -> (B, C, H, W) reconstruction logits, f32."""
        return self.feature_reconstructor(latent.to(torch.float32))

    def forward(self, x: torch.Tensor, *, noise: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """-> (reconstruction logits, mean, log_sigma, log_alpha).

        The latent is drawn by the ``fused_sample`` kernel, seeded from
        ``generator``. ``noise`` ({"eps", "unif"}) injects the draws
        instead, with ``sampling.joint_latent``'s semantics, for
        deterministic replay against the JAX model.
        """
        norm_mean, norm_log_sigma, disc_log_alpha = self.encode(x)
        if noise is None:
            latent = fused_joint_sample(norm_mean, norm_log_sigma,
                                        disc_log_alpha,
                                        self.sample_temperature,
                                        generator=generator)
        else:
            latent = sampling.joint_latent(norm_mean, norm_log_sigma,
                                           disc_log_alpha,
                                           self.sample_temperature,
                                           noise=noise, generator=generator)
        recon = self.decode(latent)
        return recon, norm_mean, norm_log_sigma, disc_log_alpha
