"""What a per-layer metric's reader sees of a traced run."""

from __future__ import annotations

from portbench.lib import trace as tr
from portbench.lib import work


class View:
    """A traced run: its ``trace`` (``lib.trace.Trace``), its counts of
    work inside the traced window (``counts``: train ``steps``,
    ``eval_forwards``, ``chunks``; or serving ``calls``), the served or
    trained ``batch``, the configuration's ``model`` section and the
    benchmark's own arithmetic (``work``)."""

    work = work

    def __init__(self, cell, run: dict):
        self.trace = run["trace"]
        self.counts = run["counts"]
        self.batch = run["batch"]
        self.model = cell.config["model"]
        self.cell = cell

    def kernel_roofline(self, expected: dict, bound_s) -> float | None:
        """100 x (the least time of every expected launch) / (their device
        time), for ``expected`` {own kernel key: [(shape, launches)]} and
        ``bound_s(key, shape)``; None unless the trace holds exactly the
        expected launches of each kernel (a trace that dropped records
        reads nothing)."""
        least = spent = 0.0
        for key, rows in expected.items():
            seconds, launches = self.trace.kernel_time_s(key)
            if launches != sum(n for _, n in rows) or seconds <= 0:
                return None
            least += sum(n * bound_s(key, shape) for shape, n in rows)
            spent += seconds
        return 100.0 * least / spent

    def scaled(self, per_unit: dict, units: int) -> dict:
        return {k: [(shape, n * units) for shape, n in rows]
                for k, rows in per_unit.items()}

    def own(self, name: str):
        return tr.own_kernel(name)
