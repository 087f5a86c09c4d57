"""Reparameterised sampling: Gaussian, Gumbel-softmax, label substitution.

Port of shotvae_tpu/ops/sampling.py:15-111 with explicit
``torch.Generator``s in place of ``jax.random`` keys. The two frameworks
draw different bits from the same seed, so cross-framework tests inject
the draws (``eps``, ``unif``, ``noise=``) and compare exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

GUMBEL_EPS = 1e-12  # parity: shotvae_tpu/ops/sampling.py:15


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One 31-bit seed from the caller's generator (the default CPU
    generator when None)."""
    device = "cpu" if generator is None else generator.device
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device).item())


def device_generator(generator: Optional[torch.Generator],
                     device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from ``generator``. With
    a host (CPU) ``generator`` the draw does not synchronise the card."""
    return torch.Generator(device=device).manual_seed(draw_seed(generator))


def sample_gaussian(mean, log_sigma, *, eps=None,
                    generator: Optional[torch.Generator] = None):
    """z = mu + exp(log_sigma) * eps,  eps ~ N(0, I). ``eps`` overrides the
    draw."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(log_sigma) * eps.to(mean.dtype)


def sample_gaussian_logvar(mean, logvar, *, eps=None,
                           generator: Optional[torch.Generator] = None):
    """z = mu + exp(0.5 * logvar) * eps, the smooth VAEs' log-variance
    convention; ``eps`` overrides the draw."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def gumbel_softmax_from_uniform(log_alpha, unif, temperature):
    """softmax((log_alpha + g) / T), g = -log(-log(u + EPS) + EPS): the
    reference's exact construction (shotvae_tpu/ops/sampling.py:39-50)."""
    unif = unif.to(log_alpha.dtype)
    gumbel = -torch.log(-torch.log(unif + GUMBEL_EPS) + GUMBEL_EPS)
    return torch.softmax((log_alpha + gumbel) / temperature, dim=1)


def sample_gumbel_softmax(log_alpha, temperature, *, unif=None,
                          generator: Optional[torch.Generator] = None):
    """Gumbel-softmax sample from log-probabilities; ``unif`` overrides the
    U[0,1) draw."""
    if unif is None:
        unif = torch.rand(log_alpha.shape, generator=generator,
                          device=log_alpha.device, dtype=log_alpha.dtype)
    return gumbel_softmax_from_uniform(log_alpha, unif, temperature)


def sample_gumbel_softmax_probs(alpha, temperature, *, unif=None,
                                generator: Optional[torch.Generator] = None):
    """Gumbel-softmax sample from probabilities, the Gumbel-softmax of
    ``log(alpha + 1e-12)`` (the smooth VAEs' convention)."""
    return sample_gumbel_softmax(torch.log(alpha + GUMBEL_EPS), temperature,
                                 unif=unif, generator=generator)


def label_onehot(labels, num_classes: int, dtype=torch.float32):
    """One-hot rows; an out-of-range label (e.g. -1) gives an all-zero row,
    as ``jax.nn.one_hot`` does."""
    labels = torch.as_tensor(labels)
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes[None, :]).to(dtype)


def discrete_latent(disc_log_alpha, temperature, *, labels=None,
                    labels_mixup=None, mixup_lam=None, unif=None,
                    generator: Optional[torch.Generator] = None):
    """The discrete half of the latent (reference vae.py:38-52).

    labeled: the one-hot replaces the sample; labeled + mixup: the convex
    combination of two one-hots; unlabeled, or a label of -1 within a mixed
    batch: the Gumbel-softmax sample.
    """
    num_classes = disc_log_alpha.shape[1]
    gumbel = sample_gumbel_softmax(disc_log_alpha, temperature, unif=unif,
                                   generator=generator)
    if labels is None:
        return gumbel
    labels = torch.as_tensor(labels, device=disc_log_alpha.device)
    c = label_onehot(labels, num_classes, disc_log_alpha.dtype)
    if labels_mixup is not None:
        c_b = label_onehot(
            torch.as_tensor(labels_mixup, device=disc_log_alpha.device),
            num_classes, disc_log_alpha.dtype)
        c = mixup_lam * c + (1.0 - mixup_lam) * c_b
    return torch.where((labels >= 0)[:, None], c, gumbel)


def joint_latent(norm_mean, norm_log_sigma, disc_log_alpha, temperature, *,
                 labels=None, labels_mixup=None, mixup_lam=None, noise=None,
                 generator: Optional[torch.Generator] = None):
    """[z ; y], shape (B, Dc + Dd) (reference vae.py:36-56).

    ``noise`` injects pre-drawn randomness: a dict with ``"eps"`` (Gaussian,
    shape of the mean) and/or ``"unif"`` (Gumbel uniforms, shape of
    log_alpha); a missing entry is drawn from ``generator``.
    """
    noise = noise or {}
    z = sample_gaussian(norm_mean, norm_log_sigma, eps=noise.get("eps"),
                        generator=generator)
    y = discrete_latent(disc_log_alpha, temperature, labels=labels,
                        labels_mixup=labels_mixup, mixup_lam=mixup_lam,
                        unif=noise.get("unif"), generator=generator)
    return torch.cat([z, y], dim=1)


def eval_discrete_onehot(alpha):
    """Eval-mode discrete sample: the argmax one-hot."""
    return label_onehot(torch.argmax(alpha, dim=1), alpha.shape[1],
                        alpha.dtype)
