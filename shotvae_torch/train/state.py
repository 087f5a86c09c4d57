"""Train state and the torch-semantics optimizer.

Port of shotvae_tpu/train/state.py:22-63. The reference trains with
``torch.optim.SGD(lr, momentum=0.9, weight_decay=5e-4)`` over every
parameter, BN affines included; the JAX package's ``sgd_torch`` copies it
with optax's ``add_decayed_weights`` + ``sgd`` chain, and here it is that
optimizer itself. The learning-rate schedule is a function of the global
step, applied to the optimizer before each update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn


def sgd_torch(model: nn.Module, lr: float = 0.1, momentum: float = 0.9,
              weight_decay: float = 5e-4) -> torch.optim.SGD:
    """SGD with momentum and coupled weight decay over every parameter:
    g += wd * p, then momentum, then lr."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           weight_decay=weight_decay)


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
