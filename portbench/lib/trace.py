"""Spans, the device trace and what is read from them.

The benchmark marks each layer boundary it calls across with a span
(``torch.profiler.record_function`` named ``pb:<layer>``), so that in a
traced run the spans and the device's kernels share one clock. Untraced,
a span costs one ``record_function`` enter and exit. The trace stays in
memory; nothing is written.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "pb:"
# the port's own kernels, by the names the device trace gives them
OWN_KERNELS = {
    "stats": r"^_stats_kernel",
    "apply": r"^_apply_kernel",
    "bwd_reduce": r"^_bwd_reduce_kernel",
    "bwd_apply": r"^_bwd_apply_kernel",
    "bn_act": r"^_bn_act_kernel",
    "conv_bf16": r"fused_bn_act_conv3x3_bf16_kernel",
    "conv_f32": r"fused_bn_act_conv3x3_kernel",
    "sample": r"fused_joint_sample_kernel",
}
_OWN = {k: re.compile(v) for k, v in OWN_KERNELS.items()}


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def own_kernel(name: str) -> Optional[str]:
    """Which of the port's kernels ``name`` is, or None."""
    for key, pattern in _OWN.items():
        if pattern.search(name):
            return key
    return None


@dataclass
class Trace:
    """A traced window: device activity and the benchmark's spans, in
    nanoseconds on one clock."""

    window: Tuple[int, int]
    kernels: List[Tuple[str, int, int]]       # device kernels
    activity: List[Tuple[str, int, int]]      # kernels, copies and fills
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's busy intervals inside the window."""
        lo, hi = self.window
        return union([(max(s, lo), min(e, hi)) for _, s, e in self.activity
                      if e > lo and s < hi])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_time_s(self, key: str) -> Tuple[float, int]:
        """(device seconds, launches) of one of the port's kernels."""
        times = [e - s for n, s, e in self.kernels if own_kernel(n) == key]
        return sum(times) / 1e9, len(times)

    def span_s(self, name: str) -> List[float]:
        return [(e - s) / 1e9 for s, e in self.spans.get(name, [])]


def union(intervals) -> List[Tuple[int, int]]:
    """Merge intervals into disjoint ones, in order."""
    out: List[List[int]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@contextlib.contextmanager
def traced():
    """Profile CPU and CUDA activity inside; yields a holder whose
    ``trace`` is filled on leaving (after a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with span("window"):
            yield holder
            torch.cuda.synchronize()
    finally:
        prof.stop()
    holder.trace = read_profile(prof)


def read_profile(prof) -> Trace:
    """The window span, the spans, and the device's activity of ``prof``,
    from its raw (Kineto) events."""
    from torch.autograd import DeviceType

    spans: Dict[str, List[Tuple[int, int]]] = {}
    kernels, activity = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.setdefault(name[len(PREFIX):], []).append((start, end))
            continue
        if ev.device_type() != DeviceType.CUDA or _annotation(ev):
            continue
        activity.append((name, start, end))
        if not name.startswith(("Memcpy", "Memset")):
            kernels.append((name, start, end))
    window = spans.pop("window")[0]
    return Trace(window, kernels, activity, spans)


def _annotation(ev) -> bool:
    """A user annotation mirrored on the device's timeline, which spans
    kernels that are counted themselves."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else ev.name().startswith(PREFIX)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    idle time inside the window by the innermost span the host was in
    when each gap began ("none" outside every span)."""
    by_op: Dict[str, float] = {}
    for name, s, e in trace.kernels:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    lo, hi = trace.window
    busy = trace.busy()
    gaps, cursor = [], lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    # sweep the spans' starts and ends along the gaps, in time order
    marks = sorted([(s, 1, e, n) for n, rows in trace.spans.items()
                    for s, e in rows]
                   + [(e, 0, s, n) for n, rows in trace.spans.items()
                      for s, e in rows])
    active: Dict[Tuple[int, int, str], int] = {}
    by_label: Dict[str, float] = {}
    i = 0
    for gs, ge in gaps:
        while i < len(marks) and marks[i][0] <= gs:
            t, opening, other, name = marks[i]
            key = (t, other, name) if opening else (other, t, name)
            if opening:
                active[key] = other - t
            else:
                active.pop(key, None)
            i += 1
        label = min(active, key=active.get)[2] if active else "none"
        by_label[label] = by_label.get(label, 0.0) + (ge - gs) / 1e9

    def ranked(d):
        return [[k[:160], v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_label)}
