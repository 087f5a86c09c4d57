"""What the port's own spans say about a traced run.

The port records a span (``shotvae_torch/utils/spans.py``) only while a
profiler collects, with its bounds from ``time.time_ns()``, the clock of
the trace's events, so the records of the traced window lie on the
device's timeline in ``View.trace``. A checkout whose port has no such
recorder, or a run that recorded none, gives no records, and every reader
of them reads nothing.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from portbench.lib.trace import union


def _recorded() -> list:
    try:
        from shotvae_torch.utils.spans import recorded
    except ImportError:
        return []
    return recorded()


def records(run) -> List[Tuple[object, bool]]:
    """The port's closed records that overlap the traced window, each with
    whether a ``chunk.*`` span encloses it (the train step's own work,
    run on the CPU's plain replay or at a capture)."""
    lo, hi = run.trace.window
    every = _recorded()

    def in_chunk(r) -> bool:
        while r.parent is not None and r.parent < len(every):
            r = every[r.parent]
            if r.name.startswith("chunk."):
                return True
        return False

    return [(r, in_chunk(r)) for r in every
            if r.end_ns is not None and r.start_ns < hi and r.end_ns > lo]


def intervals(run, names: Iterable[str],
              outside_chunks: bool = False) -> List[Tuple[int, int]]:
    """The records of ``names`` inside the window, clipped to it, in ns;
    with ``outside_chunks``, only those no ``chunk.*`` span encloses."""
    lo, hi = run.trace.window
    names = set(names)
    return [(max(r.start_ns, lo), min(r.end_ns, hi))
            for r, in_chunk in records(run)
            if r.name in names and not (outside_chunks and in_chunk)]


def host_ms_per(run, name: str, unit: str) -> Optional[float]:
    """Host milliseconds in the ``name`` spans of the window per ``unit``
    span; None where either is absent."""
    spent, units = intervals(run, [name]), intervals(run, [unit])
    if not spent or not units:
        return None
    return sum(e - s for s, e in spent) / 1e6 / len(units)


def idle_ns(run, spans: List[Tuple[int, int]]) -> int:
    """Nanoseconds of the window in which the host was inside one of
    ``spans`` and the device was idle: the union of the spans less the
    device's busy intervals (``Trace.busy``)."""
    busy = run.trace.busy()
    idle, i = 0, 0
    for s, e in union(spans):
        covered = 0
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            covered += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
        idle += (e - s) - covered
    return idle


def idle_ms_per(run, spans: List[Tuple[int, int]],
                unit: str) -> Optional[float]:
    """Device idle milliseconds inside ``spans`` per ``unit`` span; None
    where either is absent."""
    units = intervals(run, [unit])
    if not spans or not units:
        return None
    return idle_ns(run, spans) / 1e6 / len(units)
