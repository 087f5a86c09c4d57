"""The plain SHOT-VAE train step of ``shot_step`` with each encoder unit's
forward recomputed in its backward (``torch.utils.checkpoint``), for
encoders whose four forwards at the configuration's batch keep more
activations for one backward than the card holds (WideResNet-28-10 at
768 + 768: about 44 MB an image a forward in the reference's float32
BatchNorm temporaries).

The arithmetic and the draws are ``shot_step``'s: inside
``recomputed_units`` its step builds ``Net`` as this module's
``RematNet``, whose units run the same ``Net.unit`` once forward and once
again in the backward. No unit draws at random. The recompute moves no
BatchNorm running statistic: it runs on copies of the unit's running
means and variances. Imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import shot_step
from portbench.reference.model import Net

RUNNING = (".running_mean", ".running_var")


class RematNet(Net):
    """``Net`` whose units, in train mode with gradients on, keep only
    their input for the backward and run their forward again there."""

    def unit(self, prefix, x, cin, cout, stride, slope, shortcut_slope):
        if not (self.train and torch.is_grad_enabled()):
            return super().unit(prefix, x, cin, cout, stride, slope,
                                shortcut_slope)
        calls = []

        def run(h):
            net = self
            if calls:  # the recompute: running statistics on copies
                net = copy.copy(self)
                net.t = {n: (v.clone() if n.startswith(prefix)
                             and n.endswith(RUNNING) else v)
                         for n, v in self.t.items()}
            calls.append(1)
            return Net.unit(net, prefix, h, cin, cout, stride, slope,
                            shortcut_slope)

        return checkpoint(run, x, use_reentrant=False)


@contextlib.contextmanager
def recomputed_units():
    """``shot_step``'s train step with ``RematNet`` in ``Net``'s place
    inside; restored on leaving."""
    saved = shot_step.Net
    shot_step.Net = RematNet
    try:
        yield
    finally:
        shot_step.Net = saved
