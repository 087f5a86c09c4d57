"""ELBO and classification loss terms. Port of shotvae_tpu/ops/losses.py:31-166.

Reduction convention of the reference: sum over elements, mean over the
batch, unless stated otherwise; everything in float32. The smooth-ELBO
terms come with their slice.
"""

from __future__ import annotations

import math

import torch

from shotvae_torch.ops.sampling import label_onehot


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
