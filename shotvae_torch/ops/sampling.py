"""Reparameterised sampling: Gaussian, Gumbel-softmax, label substitution.

Port of shotvae_tpu/ops/sampling.py:15-111 with explicit
``torch.Generator``s in place of ``jax.random`` keys. The two frameworks
draw different bits from the same seed, so cross-framework tests inject
the draws (``eps``, ``unif``, ``noise=``) and compare exactly.

A train step takes its draws through ``StepDraws``: persistent device
generators and 0-d float32 mixup weights, one per random site, seeded from
the step's host generator in the order the sites ask. Seeding a persistent
generator gives the draws of a fresh one with the same seed, and the slots
stay where a CUDA graph that captured the step reads them. A step over a
process group draws from two host generators, the rank's own and the one
every rank shares (mixup over the global batch), each through a
``StepDraws`` of its own with its own plan.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

GUMBEL_EPS = 1e-12  # parity: shotvae_tpu/ops/sampling.py:15
LAM_SLOTS = 4       # mixup weights a step may draw (the SHOT-VAE step: 2)


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One 31-bit seed from the caller's generator (the default CPU
    generator when None)."""
    device = "cpu" if generator is None else generator.device
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device).item())


def beta_value(generator: Optional[torch.Generator], a: float,
               b: float) -> float:
    """One Beta(a, b) draw on the host, from a numpy generator seeded by
    one draw from ``generator``."""
    return float(np.random.default_rng(draw_seed(generator)).beta(a, b))


class StepDraws:
    """The random draws of one train step, from persistent slots: device
    generators and the 0-d float32 entries of ``lams``. The step's sites
    ask in program order (``device_generator``, ``mixup.draw_beta``); the
    k-th generator request gets the k-th generator, the k-th Beta request
    the k-th weight.

    ``draw(host)``: each slot is seeded (a generator) or written (a weight)
    from one draw of the host generator ``host`` as its request comes, in
    the order of fresh generators seeded one by one; the requests are
    recorded as ``plan``. ``defer()``: each request gets its slot as it
    stands and must follow ``plan``; ``seed(host)`` seeds the generators
    and returns the weights, from the same draws of ``host`` in the same
    order, before the step runs (the replay of a CUDA graph that captured
    the deferred step)."""

    def __init__(self, device, lams: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        self.lams = (torch.zeros(LAM_SLOTS, dtype=torch.float32,
                                 device=self.device)
                     if lams is None else lams)
        self.generators: List[torch.Generator] = []
        self.plan: list = []  # ("gen", device) or ("beta", a, b) a request
        self.host: Optional[torch.Generator] = None
        self.deferred = False
        self._asked = self._gens = self._betas = 0

    def draw(self, host: torch.Generator) -> "StepDraws":
        self.host, self.deferred, self.plan = host, False, []
        self._asked = self._gens = self._betas = 0
        return self

    def defer(self) -> "StepDraws":
        self.host, self.deferred = None, True
        self._asked = self._gens = self._betas = 0
        return self

    def ensure(self, plan: list) -> None:
        """Take ``plan`` and make the generators it asks for (a capture
        must find every generator it uses made and registered)."""
        self.plan = list(plan)
        gens = [torch.device(e[1]) for e in self.plan if e[0] == "gen"]
        for dev in gens[len(self.generators):]:
            self.generators.append(torch.Generator(device=dev))

    def seed(self, host: torch.Generator) -> List[float]:
        """Seed every generator of ``plan`` from ``host`` and draw every
        weight, as ``draw(host)`` would; returns the weights in slot
        order."""
        gens, lams = iter(self.generators), []
        for entry in self.plan:
            if entry[0] == "gen":
                next(gens).manual_seed(draw_seed(host))
            else:
                lams.append(beta_value(host, entry[1], entry[2]))
        return lams

    def _ask(self, entry: tuple) -> None:
        if self.deferred:
            if (self._asked >= len(self.plan)
                    or self.plan[self._asked] != entry):
                raise RuntimeError(
                    f"a deferred train step asked for {entry} as its draw "
                    f"{self._asked}; its drawing run asked for {self.plan}")
        else:
            self.plan.append(entry)
        self._asked += 1

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        self._ask(("gen", str(device)))
        k, self._gens = self._gens, self._gens + 1
        if k == len(self.generators):
            self.generators.append(torch.Generator(device=device))
        gen = self.generators[k]
        if not self.deferred:
            gen.manual_seed(draw_seed(self.host))
        return gen

    def beta(self, a: float, b: float) -> torch.Tensor:
        self._ask(("beta", float(a), float(b)))
        k, self._betas = self._betas, self._betas + 1
        if k >= self.lams.shape[0]:
            raise RuntimeError(f"a train step drew more than "
                               f"{self.lams.shape[0]} mixup weights")
        lam = self.lams[k]
        if not self.deferred:
            lam.fill_(beta_value(self.host, a, b))
        return lam


def device_generator(generator, device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from ``generator``. With
    a host (CPU) ``generator`` the draw does not synchronise the card. A
    ``StepDraws`` gives its next generator slot."""
    if isinstance(generator, StepDraws):
        return generator.generator(device)
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
