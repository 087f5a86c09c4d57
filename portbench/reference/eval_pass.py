"""The SHOT-VAE eval pass in plain PyTorch: one eval-mode forward of each
padded batch of a split, its latent drawn from the documented counter-based
stream, and the weighted sums of the per-sample terms.

Equations: FengHZ/SHOT-VAE ``main_shot_vae.py`` ``test()`` (the latent is
still sampled in eval mode; reconstruction by BCE with logits, the two KL
terms, the squared error of the sigmoid reconstruction over 2 sigma^2 and
the reference's "ELBO", that error plus a hundredth of the KL terms). A
ragged last batch is padded by wrap-around to the full
batch and its padding rows weigh 0.

The draw: batch j of an epoch's split seeds a host generator from
``SeedSequence([seed + 1000, epoch, 10000 + j])`` and takes one 31-bit draw
of it as the key of Philox-4x32-10 (Random123). Gaussian pair p of row r
(columns 2p, 2p + 1) comes from the counter (p, 0, r, 0), Gumbel group q
(columns 4q to 4q + 3) from (q, 1, r, 0), each word a uniform
``(w >> 8) * 2^-24``; Box-Muller with ``u1 + 1e-12`` in its log, and
``g = -log(-log(u + 1e-12) + 1e-12)``. Imports nothing of the program under
test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import GUMBEL_EPS, Net, matmul_precision, \
    to_images
from portbench.reference.shot_step import Draws

EVAL_KEY = 10_000
MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x):
    """(high, low) 32-bit words of m * x for 32-bit m and int64 x."""
    low = m * (x & 0xFFFF)
    high = m * (x >> 16)
    mid = low + ((high & 0xFFFF) << 16)
    return (high >> 16) + (mid >> 32), mid & MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 of the counter (c0, c1, c2, c3) under (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def _uniforms(key: int, b: int, groups: int, stream: int, device):
    rows = torch.arange(b, device=device)[:, None].expand(b, groups)
    cols = torch.arange(groups, device=device)[None, :].expand(b, groups)
    words = philox(cols, torch.full_like(cols, stream), rows,
                   torch.zeros_like(cols), key, 0)
    return [(w >> 8).to(torch.float32) * 2.0 ** -24 for w in words]


def sample(mean, log_sigma, log_alpha, temperature: float, key: int):
    """[z ; y] of one batch under the Philox key ``key``."""
    b, dc = mean.shape
    dd = log_alpha.shape[1]
    w = _uniforms(key, b, -(-dc // 2), 0, mean.device)
    u1 = torch.stack((w[0], w[2]), 2).reshape(b, -1)[:, :dc]
    u2 = torch.stack((w[1], w[3]), 2).reshape(b, -1)[:, :dc]
    u = torch.stack(_uniforms(key, b, -(-dd // 4), 1, mean.device),
                    2).reshape(b, -1)[:, :dd]
    eps = torch.sqrt(-2.0 * torch.log(u1 + 1e-12)) * torch.cos(
        2.0 * math.pi * u2)
    gumbel = -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)
    y = torch.softmax((log_alpha + gumbel) / temperature, dim=1)
    return torch.cat([mean + torch.exp(log_sigma) * eps, y], dim=1)


def padded_batches(indices: np.ndarray, batch: int):
    for start in range(0, len(indices), batch):
        idx = indices[start:start + batch]
        weight = np.zeros(batch, np.float32)
        weight[:len(idx)] = 1.0
        if len(idx) < batch:
            idx = np.concatenate([idx, np.resize(idx, batch - len(idx))])
        yield idx, weight


def eval_sums(t: dict, model: dict, trunk: str, images, indices, *,
              seed: int, epoch: int, batch: int, x_sigma: float = 1.0):
    """The weighted sums of one split's eval pass over the uint8 images
    ``images[indices]`` with the tensors ``t``, in float64."""
    k = model["num_classes"]
    sums: dict = {}
    with torch.no_grad(), matmul_precision(trunk):
        net = Net(t, model, trunk, train=False)
        for j, (idx, weight) in enumerate(padded_batches(indices, batch)):
            x = to_images(images[torch.from_numpy(idx).to(images.device)])
            mean, log_sigma, log_alpha = net.encode(x)
            key = Draws(seed, epoch, EVAL_KEY + j, x.device)._seed()
            recon = net.decode(sample(mean, log_sigma, log_alpha,
                                      model["temperature"], key))
            ckl = 0.5 * (mean * mean + torch.exp(2.0 * log_sigma)
                         - 2.0 * log_sigma - 1.0).sum(1)
            dkl = (torch.exp(log_alpha)
                   * (log_alpha - math.log(1.0 / k))).sum(1)
            mse = ((torch.sigmoid(recon) - x) ** 2).flatten(1).sum(1) \
                / (2 * x_sigma ** 2)
            per = {
                "recon_sum": (torch.clamp(recon, min=0.0) - recon * x
                              + torch.log1p(torch.exp(-recon.abs()))
                              ).flatten(1).sum(1),
                "cont_kl_sum": ckl,
                "disc_kl_sum": dkl,
                "mse_sum": mse,
                "elbo_sum": mse + 0.01 * (ckl + dkl),
            }
            w = torch.from_numpy(weight).to(x.device)
            for name, v in per.items():
                sums[name] = sums.get(name, 0.0) + float(
                    (v * w).double().sum())
    return sums
