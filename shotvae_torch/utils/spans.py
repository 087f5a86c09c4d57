"""Spans of the port's own work, for a profiler's trace.

``span(name, **counts)`` marks a stretch of the host's work as a context
manager. While no torch profiler collects, it reads one flag and does
nothing more. While one does (``torch.profiler.profile``, or the
``--profile-dir`` epoch of the CLIs), it enters
``torch.profiler.record_function("sv:" + name)``, so the span shows in
every Chrome and Kineto trace, and keeps a ``Record``: the name, its bounds
from ``time.time_ns()`` (the clock of Kineto's events, so the records and
the device's activity share one timeline), the index of the record that
encloses it on its thread (``parent``) and ``counts``: the steps, rows or
bytes it handled. Entering gives that ``counts`` dict, for counts found
inside (None while no profiler collects). ``recorded()`` gives the
records, ``clear()`` drops them; at most ``MAX_RECORDS`` are kept and
``dropped()`` counts those refused beyond.

A span inside code that a CUDA graph captures records the capture, once:
a replay runs no Python. The spans the port puts in its hot paths wrap the
code around the replay, not the code it replays.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

MAX_RECORDS = 1_000_000
PREFIX = "sv:"
_profiling = torch._C._autograd._profiler_enabled


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` None while it is open), ``parent`` (the index of the
    enclosing record, None at the top) and ``counts``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "counts")

    def __init__(self, name: str, start_ns: int, parent: Optional[int],
                 counts: dict):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.counts = parent, counts

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, counts={self.counts})")


class _Off:
    """The span while no profiler collects."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("recorder", "name", "counts", "function", "record")

    def __init__(self, recorder: "Recorder", name: str, counts: dict):
        self.recorder, self.name, self.counts = recorder, name, counts

    def __enter__(self) -> dict:
        self.function = torch.profiler.record_function(PREFIX + self.name)
        self.function.__enter__()
        self.record = self.recorder._open(self.name, self.counts)
        return self.counts

    def __exit__(self, *exc) -> bool:
        self.recorder._close(self.record)
        self.function.__exit__(*exc)
        return False


class Recorder:
    """The records of the spans entered through ``span``, up to ``cap``."""

    def __init__(self, cap: int = MAX_RECORDS):
        self.cap = cap
        self.records: List[Record] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, **counts):
        if not _profiling():
            return _OFF
        return _Span(self, name, counts)

    def _open(self, name: str, counts: dict) -> Optional[Record]:
        """The new record, or None past the cap; pushed on this thread's
        stack of open spans (by index) either way."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        record = None
        with self._lock:
            if len(self.records) >= self.cap:
                self.dropped += 1
                index = None
            else:
                index = len(self.records)
                record = Record(name, time.time_ns(), parent, counts)
                self.records.append(record)
        stack.append(index)
        return record

    def _close(self, record: Optional[Record]) -> None:
        end = time.time_ns()
        self._local.stack.pop()
        if record is not None:
            record.end_ns = end

    def recorded(self) -> List[Record]:
        with self._lock:
            return list(self.records)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0


_RECORDER = Recorder()
span = _RECORDER.span
recorded = _RECORDER.recorded
clear = _RECORDER.clear


def dropped() -> int:
    """The records refused since the last ``clear()``: past the cap."""
    return _RECORDER.dropped
