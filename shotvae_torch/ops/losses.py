"""ELBO and classification loss terms. Port of shotvae_tpu/ops/losses.py:20-271.

Reduction convention of the reference: sum over elements, mean over the
batch, unless stated otherwise; everything in float32. The SHOT-VAE terms
parameterise the continuous latent by log *sigma* and the discrete one by
log-probabilities; the smooth-ELBO (JointVAE-style) terms at the end take
log *variance* and probabilities (post-softmax), as the reference's
one-stage trainers do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from shotvae_torch.ops.sampling import label_onehot
from shotvae_torch.ops.schedules import linear_capacity

# the reference's EPS conventions: 1e-12 in the smooth-ELBO entropy, 1e-4 in
# the general KL helpers (shotvae_tpu/ops/losses.py:20-24)
EPS_ENTROPY = 1e-12
EPS_KL = 1e-4


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def _bce_elems(logits, targets):
    logits, targets = _f32(logits), _f32(targets)
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def bce_with_logits_sum(logits, targets):
    """Sum-reduced, numerically stable binary cross entropy with logits
    (the reference's ``F.binary_cross_entropy_with_logits(reduction="sum")``)."""
    return _bce_elems(logits, targets).sum()


def reconstruction_loss(x, x_recon_logits, *, bce: bool = True,
                        x_sigma: float = 1.0):
    """-log p(x|z,y): BCE with logits, or the MSE of the sigmoid over
    ``2 * x_sigma**2``; summed over pixels, mean over the batch."""
    batch = x.shape[0]
    if bce:
        return bce_with_logits_sum(x_recon_logits, x) / batch
    diff = torch.sigmoid(_f32(x_recon_logits)) - _f32(x)
    return (diff * diff).sum() / (2.0 * batch * x_sigma**2)


def gaussian_kl_stdnormal(mean, log_sigma):
    """KL[N(mean, sigma^2) || N(0, I)] with log *sigma*, sum over dims, mean
    over the batch."""
    mean, log_sigma = _f32(mean), _f32(log_sigma)
    log_sigma_sq = 2.0 * log_sigma
    return 0.5 * (mean * mean + torch.exp(log_sigma_sq) - log_sigma_sq
                  - 1.0).sum() / mean.shape[0]


def categorical_kl_uniform(disc_log_alpha, num_classes: int):
    """KL[q(y|x) || Uniform(K)], q given by log-probabilities."""
    disc_log_alpha = _f32(disc_log_alpha)
    log_prior = math.log(1.0 / num_classes)
    return (torch.exp(disc_log_alpha) * (disc_log_alpha - log_prior)).sum() \
        / disc_log_alpha.shape[0]


def elbo_terms(x, x_recon_logits, z_mean, z_log_sigma, disc_log_alpha, *,
               num_classes: int, bce: bool = True, x_sigma: float = 1.0):
    """(reconstruction, continuous KL, discrete KL)."""
    return (reconstruction_loss(x, x_recon_logits, bce=bce, x_sigma=x_sigma),
            gaussian_kl_stdnormal(z_mean, z_log_sigma),
            categorical_kl_uniform(disc_log_alpha, num_classes))


def mi_hinge(kl, mutual_info):
    """|KL - mi|, the mutual-information hinge."""
    return torch.abs(kl - mutual_info)


def cls_nll(log_probs, onehot, batch_weight=None):
    """Cross entropy of log-softmax predictions against (soft) one-hots,
    with an optional per-item 0/1 weight."""
    per_item = (_f32(log_probs) * _f32(onehot)).sum(1)
    if batch_weight is not None:
        per_item = per_item * _f32(batch_weight)
    return -per_item.mean()


def smoothed_onehot(labels, num_classes: int, smoothing: float = 0.001):
    """One-hot with the monitoring smoothing: ``1 - smoothing`` at the
    label, ``smoothing / (K - 1)`` elsewhere."""
    off = smoothing / (num_classes - 1)
    return label_onehot(labels, num_classes) * (1.0 - smoothing - off) + off


def inference_kl_metric(disc_log_alpha, labels, num_classes: int):
    """Monitoring only: KL(q(y|x) || smoothed true label), mean over the
    batch."""
    disc_log_alpha = _f32(disc_log_alpha)
    smooth = smoothed_onehot(labels, num_classes).to(disc_log_alpha.device)
    alpha = torch.exp(disc_log_alpha)
    return (alpha * disc_log_alpha - alpha * torch.log(smooth)).sum() \
        / disc_log_alpha.shape[0]


def bce_per_sample(logits, targets):
    """(B, ...) -> (B,): the BCE with logits summed within each sample (the
    eval step's per-sample term)."""
    return _bce_elems(logits, targets).flatten(1).sum(1)


def gaussian_kl_general(mean_q, log_sigma_q, mean_p=None, sigma_p=None):
    """KL[N_q || N(0, I)], or KL[N_q || N_p] with ``sigma_p`` given as
    *sigma*, with the reference's 1e-4 inside ``log(sigma_p + 1e-4)``; sum
    over dims, mean over the batch."""
    if mean_p is None or sigma_p is None:
        return gaussian_kl_stdnormal(mean_q, log_sigma_q)
    mean_q, log_sigma_q = _f32(mean_q), _f32(log_sigma_q)
    mean_p, sigma_p = _f32(mean_p), _f32(sigma_p)
    log_var_q = 2.0 * log_sigma_q
    log_var_p = 2.0 * torch.log(sigma_p + EPS_KL)
    var_p = sigma_p**2
    kl = 0.5 * (log_var_p - log_var_q + torch.exp(log_var_q) / var_p
                + (mean_q - mean_p) ** 2 / var_p - 1.0).sum()
    return kl / mean_q.shape[0]


def categorical_kl(disc_log_q, disc_p, qp_order: bool = True):
    """KL between categoricals, q in log space and p in probabilities (p
    read as ``log(p + 1e-4)``): KL[q || p] with ``qp_order``, else
    KL[p || q]; mean over the batch."""
    disc_log_q, disc_p = _f32(disc_log_q), _f32(disc_p)
    disc_log_p = torch.log(disc_p + EPS_KL)
    if qp_order:
        kl = (torch.exp(disc_log_q) * (disc_log_q - disc_log_p)).sum()
    else:
        kl = (disc_p * (disc_log_p - disc_log_q)).sum()
    return kl / disc_log_q.shape[0]


# --------------------------------------------------------------------------
# The smooth-ELBO terms (the reference's main_smooth_ELBO_mnist.py:227-386)


def smooth_recon_loss(x, x_recon):
    """The per-sample sum of squared errors, as the MSE over all elements
    times the pixels of one sample; ``x_recon`` is the decoder's Tanh
    output, not logits."""
    x, x_recon = _f32(x), _f32(x_recon)
    num_pixels = x.numel() // x.shape[0]
    return ((x_recon - x) ** 2).mean() * num_pixels


def kl_normal_loss(mean, logvar):
    """KL[N(mean, exp(logvar)) || N(0, I)], mean over the batch, summed
    over dims; and the per-dimension batch means."""
    mean, logvar = _f32(mean), _f32(logvar)
    kl_values = -0.5 * (1.0 + logvar - mean**2 - torch.exp(logvar))
    kl_means = kl_values.mean(0)
    return kl_means.sum(), kl_means


def kl_discrete_loss(alpha):
    """KL[Cat(alpha) || Uniform(K)] from probabilities: log K plus the
    batch mean of the negative entropy, with ``log(alpha + 1e-12)``."""
    alpha = _f32(alpha)
    neg_entropy = (alpha * torch.log(alpha + EPS_ENTROPY)).sum(1)
    return math.log(float(alpha.shape[-1])) + neg_entropy.mean()


def kl_multiple_discrete_loss(alphas):
    """The sum of ``kl_discrete_loss`` over the categorical heads."""
    return sum(kl_discrete_loss(a) for a in alphas)


def capacity_loss(kl, step, cap_min, cap_max, num_iters, gamma,
                  theoretical_max=None):
    """gamma * |C(step) - KL| with the linearly annealed capacity C
    (``schedules.linear_capacity``), capped at ``theoretical_max`` where
    given (the discrete capacity's sum of log K_i)."""
    cap = linear_capacity(step, cap_min, cap_max, num_iters,
                          theoretical_max=theoretical_max)
    return gamma * torch.abs(cap - kl)


def bce_probs_mean(probs, targets):
    """Mean binary cross entropy on probabilities:
    ``F.binary_cross_entropy``, which clamps its log terms at -100 and
    whose backward is ``(p - t) / max(p (1 - p), 1e-12)``, so a saturated
    probability (0 or 1) gives a large finite gradient, as the JAX
    package's custom VJP (losses.py:235-260). Its CUDA kernel asserts
    inputs in [0, 1]: give it probabilities as they are."""
    return F.binary_cross_entropy(_f32(probs), _f32(targets))
