"""Batched pairwise distances between vectors and between diagonal
Gaussians. Port of shotvae_tpu/utils/dist_metrics.py:15-47 (the
reference's lib/utils/calculate_dist.py, which no driver imports), as
matrix products. The pairwise Gaussian KL is the one that backs
optimal-match mixup (``shotvae_torch.ops.mixup.pairwise_gaussian_kl``),
re-exported here.
"""

from __future__ import annotations

import torch

from shotvae_torch.ops.mixup import pairwise_gaussian_kl  # noqa: F401


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def pairwise_euclidean_sq(a, b):
    """||a_i - b_j||^2 for (N, D) and (M, D) -> (N, M), expanded as
    |a|^2 + |b|^2 - 2 a.b and floored at 0."""
    a, b = _f32(a), _f32(b)
    aa = (a * a).sum(1)[:, None]
    bb = (b * b).sum(1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def pairwise_euclidean(a, b):
    return torch.sqrt(pairwise_euclidean_sq(a, b) + 1e-12)


def pairwise_cosine(a, b):
    """The cosine *similarity* matrix (N, M)."""
    a, b = _f32(a), _f32(b)
    a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-12)
    return a @ b.T


def pairwise_gaussian_wasserstein2(mean_a, log_sigma_a, mean_b, log_sigma_b):
    """The squared W2 distance between diagonal Gaussians for every ordered
    pair: ||mu_a - mu_b||^2 + sum_d (sigma_a_d - sigma_b_d)^2."""
    return (pairwise_euclidean_sq(mean_a, mean_b)
            + pairwise_euclidean_sq(torch.exp(_f32(log_sigma_a)),
                                    torch.exp(_f32(log_sigma_b))))
