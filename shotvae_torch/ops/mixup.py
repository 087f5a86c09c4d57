"""Mixup and label-smoothing interpolation for the SHOT-VAE, and the
classic input mixup helpers.

Port of shotvae_tpu/ops/mixup.py:19-168. The optimal-match partner comes
from the vectorised pairwise Gaussian KL with the diagonal masked, as in
the JAX package, its three matrix products taking their operands rounded
to bfloat16 and adding in float32 (``MATCH_OPERAND_DTYPE``): the
arithmetic of XLA's default precision for a float32 matmul on a TPU,
where the JAX package's learning results were taken. With exact float32
products the SHOT-VAE recipe learns worse (ROADMAP queue 3, F6).
``gather_mixup`` draws over the global batch of several ranks.
``mixup_data``, ``mixup_raw_labeled_data`` and ``mixup_criterion`` are
the reference's classic input mixup (its lib/utils/mixup.py, unused by
its drivers but part of its surface).

Randomness: ``generator`` is a host (CPU) ``torch.Generator`` or a train
step's ``sampling.StepDraws``. The interpolation weight is drawn on the
host, as the reference did (shotvae_tpu/ops/mixup.py:7-8), by a numpy
``Generator`` seeded with one draw from it (``torch.distributions.Beta``
takes no generator): a Python float from a host generator, the step's
0-d float32 weight slot from a ``StepDraws``; the card is not synchronised
for it. The interpolations compute with the weight as a 0-d float32
tensor, as the JAX package does, so ``1 - lam`` rounds in float32. The
partner permutation is drawn on the tensors' device by ``torch.randperm``
with a generator seeded from ``generator``. ``lam=`` / ``index=``
override the draws for deterministic replay.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from shotvae_torch.ops.sampling import StepDraws, beta_value, device_generator


class MixupBatch(NamedTuple):
    """Interpolated inputs and posterior targets (no gradient)."""

    image: torch.Tensor       # lam * x + (1-lam) * x[perm]
    z_mean: torch.Tensor      # interpolated posterior mean
    z_sigma: torch.Tensor     # interpolated posterior *sigma*
    disc_alpha: torch.Tensor  # interpolated posterior *probabilities*
    partner_labels: Optional[torch.Tensor]  # labels[perm] (label smoothing)
    lam: object               # float, or the step's 0-d weight slot


# the operands' dtype of the optimal match's KL products (None: float32)
MATCH_OPERAND_DTYPE: Optional[torch.dtype] = torch.bfloat16


def pairwise_gaussian_kl(z_mean, z_log_sigma,
                         operand_dtype: Optional[torch.dtype] = None):
    """KL[N_i || N_j] for every ordered pair, (B, B), as matrix products,
    in float32; with ``operand_dtype`` each product's operands are first
    rounded to it (the products of bfloat16 values are exact in float32,
    the sums float32)."""
    def mm(a, b):
        if operand_dtype is not None:
            a, b = a.to(operand_dtype).float(), b.to(operand_dtype).float()
        return a @ b.T

    z_mean = z_mean.to(torch.float32)
    z_log_sigma = z_log_sigma.to(torch.float32)
    dim = z_mean.shape[1]
    var = torch.exp(2.0 * z_log_sigma)
    inv_var = torch.exp(-2.0 * z_log_sigma)
    ls_row = z_log_sigma.sum(1)
    term_logdet = ls_row[None, :] - ls_row[:, None]
    term_trace = 0.5 * mm(var, inv_var)
    mu_sq = z_mean * z_mean
    term_mahal = 0.5 * (mm(mu_sq, inv_var) - 2.0 * mm(z_mean, z_mean * inv_var)
                        + (mu_sq * inv_var).sum(1)[None, :])
    return term_logdet + term_trace + term_mahal - 0.5 * dim


def optimal_match_index(z_mean, z_log_sigma):
    """Partner = the smallest-KL *other* sample of each row, from the KL
    with ``MATCH_OPERAND_DTYPE`` operands; the diagonal is masked, since
    the expanded KL has rounding noise there."""
    kl = pairwise_gaussian_kl(z_mean, z_log_sigma, MATCH_OPERAND_DTYPE)
    eye = torch.eye(kl.shape[0], dtype=kl.dtype, device=kl.device)
    return torch.argmin(kl + eye * 3.4e38, dim=1)


def draw_beta(generator, a: float, b: float):
    """One Beta(a, b) draw on the host, from a numpy generator seeded by
    ``generator``: a float, or a ``StepDraws``' weight slot holding it."""
    if isinstance(generator, StepDraws):
        return generator.beta(a, b)
    return beta_value(generator, a, b)


def _weight(lam, device):
    """(``lam`` as a 0-d float32 tensor on ``device``, ``lam`` as it is
    returned: a tensor slot stays itself, anything else becomes a
    float)."""
    if not isinstance(lam, torch.Tensor):
        lam = float(lam)
    return torch.as_tensor(lam, dtype=torch.float32, device=device), lam


def _permutation(generator, n: int, device):
    return torch.randperm(n, generator=device_generator(generator, device),
                          device=device)


def mixup_vae_data(image, z_mean, z_log_sigma, disc_log_alpha, *,
                   optimal_match: bool = False, lam=None, index=None,
                   generator: Optional[torch.Generator] = None) -> MixupBatch:
    """Posterior-interpolation mixup for the unlabeled stream: lam ~
    Beta(2, 2); partner from a random permutation or the optimal KL match;
    image, z-mean, z-*sigma* and y-*alpha* (probabilities) interpolated.
    An injected ``index`` wins even under ``optimal_match``."""
    if lam is None:
        lam = draw_beta(generator, 2.0, 2.0)
    if index is None:
        index = (optimal_match_index(z_mean, z_log_sigma) if optimal_match
                 else _permutation(generator, image.shape[0], image.device))
    return _interpolate(image, z_mean, z_log_sigma, disc_log_alpha, index,
                        lam, labels=None)


def label_smoothing(image, z_mean, z_log_sigma, disc_log_alpha, labels, *,
                    epsilon: float = 0.1, lam=None, index=None,
                    generator: Optional[torch.Generator] = None
                    ) -> MixupBatch:
    """Label-smoothing-strength interpolation for the labeled stream: lam ~
    Beta(eps, eps), a random-permutation partner, and the partner's
    label."""
    if lam is None:
        lam = draw_beta(generator, epsilon, epsilon) if epsilon > 0 else 1.0
    if index is None:
        index = _permutation(generator, image.shape[0], image.device)
    return _interpolate(image, z_mean, z_log_sigma, disc_log_alpha, index,
                        lam, labels=labels)


def _classic_mix(image, alpha: float, lam, index, generator):
    """lam ~ Beta(alpha, alpha) (1 where ``alpha`` is 0) and one partner
    permutation, each unless given; the mixed images."""
    if lam is None:
        lam = draw_beta(generator, alpha, alpha) if alpha > 0 else 1.0
    if index is None:
        index = _permutation(generator, image.shape[0], image.device)
    index = torch.as_tensor(index, device=image.device).long()
    w, lam = _weight(lam, image.device)
    return w * image + (1.0 - w) * image[index], index, lam


def mixup_data(image, label, alpha: float = 1.0, *, lam=None, index=None,
               generator: Optional[torch.Generator] = None):
    """Classic input mixup: (mixed image, label_a, label_b, lam)."""
    mixed, index, lam = _classic_mix(image, alpha, lam, index, generator)
    return mixed, label, label[index.to(label.device)], lam


def mixup_raw_labeled_data(image, label, label_weight, alpha: float = 1.0, *,
                           lam=None, index=None,
                           generator: Optional[torch.Generator] = None):
    """Input mixup carrying per-item label weights, one permutation for
    the labels and the weights: (mixed image, label_a, label_b, weight_a,
    weight_b, lam)."""
    mixed, index, lam = _classic_mix(image, alpha, lam, index, generator)
    return (mixed, label, label[index.to(label.device)], label_weight,
            label_weight[index.to(label_weight.device)], lam)


def mixup_criterion(criterion, prediction, label_a, label_b, lam):
    """lam * criterion(label_a, pred) + (1 - lam) * criterion(label_b,
    pred), labels first, in the reference's argument order."""
    return lam * criterion(label_a, prediction) + (1.0 - lam) * criterion(
        label_b, prediction)


def gather_mixup(dp, fn, arrays, **kw) -> MixupBatch:
    """A mixup or label-smoothing draw (``fn``: ``label_smoothing`` or
    ``mixup_vae_data``) over the GLOBAL batch of the ranks of ``dp``: the
    inputs ``arrays`` (images, z mean, z log sigma, y log alpha, and labels
    for label smoothing) gathered in rank order, the draw made on the global
    batch with a generator every rank shares (so the weight, the partners
    and the optimal match agree on every rank), and this rank's rows sliced
    back out. Port of shotvae_tpu/train/steps.py:81-105 (``gather_mixup``);
    the JAX package's GSPMD step mixes over the global batch the same
    way."""
    out = fn(*(dp.gather_rows(a) for a in arrays), **kw)
    rows = dp.rows(out.image.shape[0])
    sl = lambda t: None if t is None else t[rows]  # noqa: E731
    return MixupBatch(sl(out.image), sl(out.z_mean), sl(out.z_sigma),
                      sl(out.disc_alpha), sl(out.partner_labels), out.lam)


def _interpolate(image, z_mean, z_log_sigma, disc_log_alpha, index, lam, *,
                 labels):
    index = torch.as_tensor(index, device=image.device).long()
    w, lam = _weight(lam, image.device)
    mix = lambda t: w * t + (1.0 - w) * t[index]  # noqa: E731
    return MixupBatch(mix(image), mix(z_mean), mix(torch.exp(z_log_sigma)),
                      mix(torch.exp(disc_log_alpha)),
                      None if labels is None else labels[index], lam)
