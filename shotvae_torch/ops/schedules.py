"""Epoch and step schedules. Port of shotvae_tpu/ops/schedules.py:19-82.

Plain Python functions of the epoch or the global step: the port updates
its optimizer's learning rate on the host before each step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np


def alpha_schedule(epoch, max_epoch, alpha_max):
    """Mean-teacher sigmoidal ramp: alpha_max * exp(-5 (1 - min(1, e/E))^2);
    fully ramped where ``max_epoch <= 0``."""
    if max_epoch <= 0:
        return alpha_max
    return alpha_max * math.exp(-5.0 * (1.0 - min(1.0, epoch / max_epoch))
                                ** 2)


def shot_vae_epoch_schedules(epoch, cfg) -> dict:
    """The SHOT-VAE trainer's per-epoch scalar weights (cmi, dmi, ew,
    kl_beta_c, kl_beta_d, pwm, ucw). ``cfg`` needs akb, cmi, dmi, aew, ewm,
    kbmc, kbmd, apw, pwm, wmf, epochs and wrd (``config.ShotVaeConfig``)."""
    return {
        "cmi": alpha_schedule(epoch, cfg.akb, cfg.cmi),
        "dmi": alpha_schedule(epoch, cfg.akb, cfg.dmi),
        "ew": alpha_schedule(epoch, cfg.aew, cfg.ewm),
        "kl_beta_c": alpha_schedule(epoch, cfg.akb, cfg.kbmc),
        "kl_beta_d": alpha_schedule(epoch, cfg.akb, cfg.kbmd),
        "pwm": alpha_schedule(epoch, cfg.apw, cfg.pwm),
        "ucw": alpha_schedule(epoch, round(cfg.wmf * cfg.epochs), cfg.wrd),
    }


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 steps_per_epoch: int, gamma: float = 0.1,
                 warmup_factor: float = 0.2) -> Callable[[int], float]:
    """Piecewise-constant LR of the global step: ``base_lr * warmup_factor``
    through epoch 0, ``base_lr`` from epoch 1, times ``gamma`` per milestone.

    The reference steps its MultiStepLR at the END of epoch ``m``, so the
    decayed rate is first used at the start of epoch ``m + 1``: the boundary
    sits at step ``(m + 1) * steps_per_epoch`` (the JAX package's README
    "Parity and documented deviations" 5). A boundary applies from the step
    it names on, as optax's ``piecewise_constant_schedule`` does.
    """
    boundaries = {steps_per_epoch: 1.0 / warmup_factor}
    for m in milestones:
        key = (m + 1) * steps_per_epoch
        boundaries[key] = boundaries.get(key, 1.0) * gamma
    ordered = sorted(boundaries.items())

    def lr(step: int) -> float:
        value = base_lr * warmup_factor
        for boundary, scale in ordered:
            if step >= boundary:
                value *= scale
        return value

    return lr


def linear_capacity(step, cap_min, cap_max, num_iters,
                    theoretical_max: Optional[float] = None) -> float:
    """The JointVAE capacity C(step) = (cap_max - cap_min) * step /
    num_iters + cap_min, clamped at ``cap_max`` (and ``theoretical_max``
    where given). Computed in float32, as the JAX package computes it
    inside its step, and returned as the Python float of that value."""
    f32 = np.float32
    cap = f32(cap_max - cap_min) * f32(step) / f32(num_iters) + f32(cap_min)
    cap = min(cap, f32(cap_max))
    if theoretical_max is not None:
        cap = min(cap, f32(theoretical_max))
    return float(cap)
