"""The readers of the port's own spans (``portbench/lib/program.py`` and
the metrics that use it) on hand-made records and a synthetic trace: each
metric's arithmetic, an idle gap that straddles two spans, the train
step's gathers left out of the eval's, records outside the window or
still open left out, and nothing read where the port records nothing."""

import sys

import pytest

from portbench.lib import cells, program
from portbench.lib.trace import Trace
from shotvae_torch.utils.spans import Record

TRAIN = ["chunk_copy_ms.train", "chunk_seed_ms.train",
         "chunk_replay_ms.train", "runner_idle_ms.train",
         "eval_step_ms.train", "eval_idle_ms.train"]
SERVE = ["serve_copy_ms.serve", "serve_forward_ms.serve",
         "serve_idle_ms.serve"]


def _records(rows):
    """Records from (name, start, end, parent) rows, in order."""
    out = []
    for name, start, end, parent in rows:
        r = Record(name, start, parent, {})
        r.end_ns = end
        out.append(r)
    return out


def _run(busy):
    activity = [("k", s, e) for s, e in busy]
    return type("Run", (), {"trace": Trace((0, 1000), activity,
                                           activity)})()


TRAIN_ROWS = [
    ("chunk.run", 100, 300, None),        # 0
    ("chunk.copy_in", 100, 150, 0),
    ("chunk.seed", 150, 200, 0),
    ("chunk.copy_in", 200, 210, 0),
    ("chunk.replay", 210, 290, 0),
    ("chunk.run", 400, 600, None),        # 5
    ("chunk.copy_in", 400, 480, 5),
    ("chunk.seed", 480, 520, 5),
    ("chunk.copy_in", 520, 530, 5),
    ("chunk.replay", 530, 590, 5),        # 9
    ("data.gather", 545, 555, 9),         # a train step's: not the eval's
    ("data.gather", 700, 720, None),
    ("eval.step", 720, 800, None),
    ("data.gather", 850, 860, None),
    ("eval.step", 860, 900, None),
    ("chunk.run", 1100, 1200, None),      # after the window
    ("eval.step", 950, None, None),       # still open
]
# busy (0, 120), (250, 420), (590, 705), (740, 770), (790, 870), (880, 1000):
# the gap (705, 740) straddles the gather (700, 720) and the eval step
TRAIN_BUSY = [(0, 120), (250, 420), (590, 705), (740, 770), (790, 870),
              (880, 1000)]


def test_train_readers(monkeypatch):
    monkeypatch.setattr(program, "_recorded",
                        lambda: _records(TRAIN_ROWS))
    run = _run(TRAIN_BUSY)
    got = {m: cells.reader(m)(run) for m in TRAIN}
    ns = 1e-6  # ms
    assert got == pytest.approx({
        "chunk_copy_ms.train": (50 + 10 + 80 + 10) / 2 * ns,
        "chunk_seed_ms.train": (50 + 40) / 2 * ns,
        "chunk_replay_ms.train": (80 + 60) / 2 * ns,
        # (100, 300) less 20 + 50 busy; (400, 600) less 20 + 10
        "runner_idle_ms.train": (130 + 170) / 2 * ns,
        "eval_step_ms.train": (80 + 40) / 2 * ns,
        # (700, 800) less 5 + 30 + 10 busy; (850, 900) less 20 + 20
        "eval_idle_ms.train": (55 + 10) / 2 * ns})


def test_idle_inside_spans():
    run = _run(TRAIN_BUSY)
    # the straddling gap, split between two adjacent spans or as one
    assert program.idle_ns(run, [(700, 720)]) == 15
    assert program.idle_ns(run, [(720, 800)]) == 40
    assert program.idle_ns(run, [(700, 720), (720, 800)]) == 55
    assert program.idle_ns(run, [(700, 800), (710, 760)]) == 55
    assert program.idle_ns(run, []) == 0
    assert program.idle_ns(_run([]), [(0, 1000)]) == 1000


def test_serve_readers(monkeypatch):
    rows = [("serve.classify", 0, 300, None), ("serve.copy_in", 10, 100, 0),
            ("serve.forward", 100, 290, 0),
            ("serve.classify", 400, 700, None), ("serve.copy_in", 400, 500, 3),
            ("serve.forward", 500, 690, 3)]
    monkeypatch.setattr(program, "_recorded", lambda: _records(rows))
    run = _run([(50, 250), (280, 450), (600, 1000)])
    got = {m: cells.reader(m)(run) for m in SERVE}
    ns = 1e-6
    assert got == pytest.approx({
        "serve_copy_ms.serve": (90 + 100) / 2 * ns,
        "serve_forward_ms.serve": (190 + 190) / 2 * ns,
        # (0, 300) less 200 + 20 busy; (400, 700) less 50 + 100
        "serve_idle_ms.serve": (80 + 150) / 2 * ns})


def test_nothing_read_without_the_ports_spans(monkeypatch):
    run = _run(TRAIN_BUSY)
    monkeypatch.setattr(program, "_recorded", lambda: [])
    assert all(cells.reader(m)(run) is None for m in TRAIN + SERVE)
    # a port without the recorder (an import that fails) records nothing
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "shotvae_torch.utils.spans", None)
    assert program._recorded() == []
    assert all(cells.reader(m)(run) is None for m in TRAIN + SERVE)
