"""The one-stage smooth-ELBO conv VAEs for MNIST and SVHN. Port of
shotvae_tpu/models/smooth_vae.py:29-124 (the reference's
smooth_vae_model/mnist_vae.py and svhn_vae.py).

Three Conv(k4, s2, p1) + ReLU, a hidden Linear + ReLU, the heads (mean,
log-variance, one softmax-probability head per discrete variable), the
draw, then Linear + ReLU, Linear + ReLU, a reshape to (C, 4, 4) and
ConvTranspose(k4, s2, p1) stages, ReLU between them and Tanh at the end
(inputs are normalised to [-1, 1]).

Conventions of the smooth VAEs, kept: the continuous latent is
parameterised by log *variance*; the discrete heads emit *probabilities*;
train mode draws z and y (Gaussian, Gumbel-softmax of the probabilities),
eval mode takes z = mean and y = the argmax one-hot; on the labeled path
the label's one-hot replaces head 0's draw in the latent, while the
returned ``disc_samples`` still hold head 0's draw.

Module names are the reference's, the keys of the JAX package's
``export_smooth_vae_state_dict``: ``img_to_features.{0,2,4}``,
``features_to_hidden.0``, ``fc_mean``, ``fc_log_var``, ``fc_alphas.{i}``,
``latent_to_features.{0,2}`` and ``features_to_img.{0,2,4}``. Flattening
and the decoder's reshape are torch's (C, H, W) order; the JAX package's
(H, W, C) order lives only in the weight bridge
(``shotvae_torch.io.jax_weights.smooth_vae_state_dict_from_jax``).

Init: torch's default weight init of each Conv2d and Linear
(U(+-1/sqrt(fan_in))); each ConvTranspose2d weight U(+-1/sqrt(fan_in)) with
the JAX package's fan_in, its *input* channels times the kernel area
(``decoder.conv_transpose``; torch's default takes the output channels);
zero biases (the JAX package's documented deviation 4).
``dtype`` (None: float32) is the compute dtype of the convs, the hidden
layer and the decoder, as the JAX module's: the hidden activations return
to float32 before the heads, and the Tanh output is float32. The convs are
library ops (cuDNN on the card), as the JAX package leaves them to XLA:
this model has no BatchNorm, so no hand kernel site.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shotvae_torch.device import DeviceLike, resolve_device
from shotvae_torch.models.decoder import conv_transpose
from shotvae_torch.models.layers import conv, linear, zero_biases_
from shotvae_torch.ops import sampling


def mnist_vae_config() -> dict:
    """mnist_VAE's hyperparameters (mnist_vae.py:21-22,48-65,95-105)."""
    return dict(img_channels=1, encoder_channels=(32, 64, 64), hidden_dim=256,
                reshape_channels=64, decoder_channels=(32, 32),
                latent_cont_dim=10, disc_dims=(10,))


def svhn_vae_config() -> dict:
    """svhn_VAE's hyperparameters (svhn_vae.py:21-22,67,77,96,124-132): a
    wider decoder, ConvTranspose 128 -> 64 -> 32 -> 3."""
    return dict(img_channels=3, encoder_channels=(32, 64, 128), hidden_dim=512,
                reshape_channels=128, decoder_channels=(64, 32),
                latent_cont_dim=32, disc_dims=(10,))


class SmoothVAE(nn.Module):
    def __init__(self, img_channels: int = 1,
                 encoder_channels: Sequence[int] = (32, 64, 64),
                 hidden_dim: int = 256, reshape_channels: int = 64,
                 decoder_channels: Sequence[int] = (32, 32),
                 latent_cont_dim: int = 10, disc_dims: Sequence[int] = (10,),
                 temperature: float = 0.67,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.img_channels = img_channels
        self.encoder_channels = tuple(encoder_channels)
        self.reshape_channels = reshape_channels
        self.latent_cont_dim = latent_cont_dim
        self.disc_dims = tuple(disc_dims)
        self.temperature = temperature
        self.dtype = dtype
        layers, cin = [], img_channels
        for cout in self.encoder_channels:
            layers += [nn.Conv2d(cin, cout, 4, stride=2, padding=1),
                       nn.ReLU()]
            cin = cout
        self.img_to_features = nn.Sequential(*layers)
        self.features_to_hidden = nn.Sequential(
            nn.Linear(cin * 4 * 4, hidden_dim), nn.ReLU())
        self.fc_mean = nn.Linear(hidden_dim, latent_cont_dim)
        self.fc_log_var = nn.Linear(hidden_dim, latent_cont_dim)
        self.fc_alphas = nn.ModuleList(nn.Linear(hidden_dim, d)
                                       for d in self.disc_dims)
        self.latent_to_features = nn.Sequential(
            nn.Linear(self.latent_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, reshape_channels * 4 * 4), nn.ReLU())
        layers, cin = [], reshape_channels
        for cout in (*decoder_channels, img_channels):
            layers += [conv_transpose(cin, cout, 4, bias=True, stride=2,
                                      padding=1), nn.ReLU()]
            cin = cout
        layers[-1] = nn.Tanh()
        self.features_to_img = nn.Sequential(*layers)
        zero_biases_(self)
        self.to(device=resolve_device(device))

    @property
    def latent_dim(self) -> int:
        return self.latent_cont_dim + sum(self.disc_dims)

    def encode(self, x: torch.Tensor):
        """(B, C, 32, 32) -> the hidden layer's f32 activations."""
        h = x.to(self.dtype or torch.float32)
        for layer in self.img_to_features[::2]:
            h = F.relu(conv(layer, h, self.dtype))
        return F.relu(linear(self.features_to_hidden[0], h.flatten(1),
                             self.dtype)).to(torch.float32)

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, latent_dim) -> the f32 Tanh reconstruction (B, C, 32, 32)."""
        fc0, fc1 = self.latent_to_features[0], self.latent_to_features[2]
        d = F.relu(linear(fc0, latent, self.dtype))
        d = F.relu(linear(fc1, d, self.dtype))
        d = d.reshape(latent.shape[0], self.reshape_channels, 4, 4)
        convs = self.features_to_img[::2]
        for layer in convs[:-1]:
            d = F.relu(conv(layer, d, self.dtype))
        return torch.tanh(conv(convs[-1], d, self.dtype).to(torch.float32))

    def forward(self, x: torch.Tensor, labels=None, noise=None,
                generator: Optional[torch.Generator] = None):
        """(B, C, 32, 32) images in [-1, 1] -> (reconstruction,
        ``{"cont": (mean, logvar), "disc": [alpha per head]}``, the latent
        sample, the discrete samples).

        Train mode draws: ``noise`` injects pre-drawn randomness
        (``{"eps": (B, Dc), "unif": [(B, K_i) per head]}``); what it does
        not hold is drawn on x's device from a generator seeded by one
        draw from ``generator`` (a host generator: the card is not
        synchronised for it). Eval mode draws nothing."""
        hidden = self.encode(x)
        mean = self.fc_mean(hidden)
        logvar = self.fc_log_var(hidden)
        alphas = [torch.softmax(fc(hidden), dim=1) for fc in self.fc_alphas]
        if self.training:
            nz = noise or {}
            gen = (None if generator is None
                   else sampling.device_generator(generator, x.device))
            parts = [sampling.sample_gaussian_logvar(
                mean, logvar, eps=nz.get("eps"), generator=gen)]
            unifs = nz.get("unif") or [None] * len(alphas)
            disc_samples = [
                sampling.sample_gumbel_softmax_probs(a, self.temperature,
                                                     unif=u, generator=gen)
                for a, u in zip(alphas, unifs)]
        else:
            parts = [mean]
            disc_samples = [sampling.eval_discrete_onehot(a) for a in alphas]
        if labels is not None:
            labels = torch.as_tensor(labels, device=x.device)
            parts.append(sampling.label_onehot(labels, self.disc_dims[0]))
            parts.extend(disc_samples[1:])
        else:
            parts.extend(disc_samples)
        latent_sample = torch.cat(parts, dim=1)
        recon = self.decode(latent_sample)
        return recon, {"cont": (mean, logvar), "disc": alphas}, \
            latent_sample, disc_samples
