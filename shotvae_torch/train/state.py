"""Train state and the torch-semantics optimizers.

Port of shotvae_tpu/train/state.py:22-69. The reference trains with
``torch.optim.SGD(lr, momentum=0.9, weight_decay=5e-4)`` over every
parameter, BN affines included, and its smooth-ELBO scripts with
``torch.optim.Adam`` at its defaults; the JAX package's ``sgd_torch`` and
``adam_torch`` copy them with optax chains, and here they are those
optimizers themselves (SGD in torch's fused form, whose update reads a
rate given as a tensor on the device, so that a CUDA graph of train steps
reads the rate written before each replay: ``train.chunk``). The
learning-rate schedule is a function of the global step, applied to the
optimizer before each update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn


def sgd_torch(model: nn.Module, lr: float = 0.1, momentum: float = 0.9,
              weight_decay: float = 5e-4) -> torch.optim.SGD:
    """SGD with momentum and coupled weight decay over every parameter:
    g += wd * p, then momentum, then lr. Fused: one kernel for the update,
    whose rate may be a 0-d tensor on the device (the same update as a
    float rate, bit for bit); within a last-ulp rounding of torch's
    default foreach SGD."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           weight_decay=weight_decay, fused=True)


def adam_torch(model: nn.Module, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam at torch's defaults (main_smooth_ELBO_mnist.py:424) over every
    parameter."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(b1, b2),
                            eps=eps)


@dataclass
class TrainState:
    """The model, its optimizer, the LR schedule and the step counter (the
    number of updates made so far)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Optional[Callable[[int], float]] = None
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at the schedule's rate for this step."""
        if self.lr_schedule is not None:
            lr = self.lr_schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1
