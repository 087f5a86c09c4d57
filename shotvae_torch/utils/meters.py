"""Running meters for host-side metric aggregation. Port of
shotvae_tpu/utils/meters.py:16-63.

``AverageMeter`` keeps val / avg / sum / count, as the reference's meter.
``MetricAccumulator`` sums whole metric dicts of 0-d tensors, moving each
dict to the host in one transfer (one device synchronise), not one per
metric.
"""

from __future__ import annotations

from typing import Dict

import torch


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: float = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)


def _host_floats(metrics: Dict) -> Dict[str, float]:
    """{name: float} of a dict of 0-d tensors (on one device) or numbers;
    the tensors cross to the host in one transfer, as float64, so every
    float32 value arrives exactly."""
    tensors = {k: v for k, v in metrics.items() if torch.is_tensor(v)}
    out = {k: float(v) for k, v in metrics.items() if k not in tensors}
    if tensors:
        stacked = torch.stack([v.detach().reshape(()).to(torch.float64)
                               for v in tensors.values()])
        out.update(zip(tensors, stacked.tolist()))
    return {k: out[k] for k in metrics}


class MetricAccumulator:
    """Sums metric dicts and exposes means.

    Made for the eval step, which returns per-batch SUMS plus a ``count``:
    ``averages()`` divides every ``*_sum`` by the total count (as
    ``*_avg``), turns every ``*_count`` into a ``*_rate`` and passes
    ``count`` through.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}

    def update(self, metrics: Dict):
        for k, v in _host_floats(metrics).items():
            self.totals[k] = self.totals.get(k, 0.0) + v

    def averages(self) -> Dict[str, float]:
        count = self.totals.get("count", 0.0) or 1.0
        out = {}
        for k, v in self.totals.items():
            if k == "count":
                out[k] = v
            elif k.endswith("_sum"):
                out[k[:-4] + "_avg"] = v / count
            elif k.endswith("_count"):
                out[k[:-6] + "_rate"] = v / count
            else:
                out[k] = v / count
        return out
