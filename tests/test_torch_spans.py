"""The port's spans (``shotvae_torch/utils/spans.py``) on the CPU: nothing
recorded and no ``sv:`` event without a profiler; under one, nested
records with their parents and counts, on the clock of their Kineto
events; the spans of a ``ChunkRunner``'s chunks (eager, then copies,
seeding and replay, a capture once a length), of ``classify`` and of the
eval step; the record cap; and ``chip_smoke.py``'s busy time as a union of
intervals."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.data.datasets import ArrayDataset
from shotvae_torch.data.pipeline import DeviceDataset
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.train.chunk import LR, ChunkRunner
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import make_vae_eval_step
from shotvae_torch.utils import spans

NET, DC, K = "wideresnet-10-1", 8, 10


@pytest.fixture(autouse=True)
def fresh_records():
    spans.clear()
    yield
    spans.clear()


def _profiled(fn):
    """``fn()`` under a CPU profiler; (its result, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _sv_events(prof) -> list:
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(spans.PREFIX)]


def _by_name(records) -> dict:
    out = {}
    for i, r in enumerate(records):
        out.setdefault(r.name, []).append(i)
    return out


def test_no_profiler_records_nothing():
    with spans.span("outer", steps=2) as counts:
        assert counts is None
        with spans.span("inner"):
            pass
    assert spans.recorded() == [] and spans.dropped() == 0
    # no record_function was left open: a profiler after sees no sv: event
    _, prof = _profiled(lambda: torch.ones(2).sum())
    assert _sv_events(prof) == []


def test_nested_spans_parents_counts_and_kineto_bounds():
    # a process's first record_function looks its op up (about 1 ms here)
    # after its event starts and before the record does
    with torch.profiler.record_function("warm"):
        pass

    def nest():
        with spans.span("outer", steps=3):
            for rows in (4, 5):
                with spans.span("inner", rows=rows) as counts:
                    torch.ones(64).sum()
                    counts["bytes"] = 8 * rows
        with spans.span("after"):
            pass

    _, prof = _profiled(nest)
    records = spans.recorded()
    assert [(r.name, r.parent, r.counts) for r in records] == [
        ("outer", None, {"steps": 3}),
        ("inner", 0, {"rows": 4, "bytes": 32}),
        ("inner", 0, {"rows": 5, "bytes": 40}),
        ("after", None, {})]
    for r in records:
        assert r.start_ns <= r.end_ns
    assert records[0].start_ns <= records[1].start_ns
    assert records[2].end_ns <= records[0].end_ns
    events = sorted(_sv_events(prof), key=lambda e: e[1])
    assert [n for n, _, _ in events] == ["sv:" + r.name for r in records]
    for r, (_, start, end) in zip(records, events):
        assert abs(r.start_ns - start) < 1_000_000, r
        assert abs(r.end_ns - end) < 1_000_000, r


def test_record_cap_counts_what_it_drops():
    recorder = spans.Recorder(cap=2)

    def many():
        with recorder.span("a"):
            with recorder.span("b"):
                pass
            with recorder.span("c"):
                with recorder.span("d"):
                    pass

    _profiled(many)
    assert [(r.name, r.parent) for r in recorder.recorded()] == [
        ("a", None), ("b", 0)]
    assert recorder.dropped == 2
    recorder.clear()
    assert recorder.recorded() == [] and recorder.dropped == 0


# a chunk runner over a tiny linear model: each step gathers its rows,
# draws one generator and one mixup weight, and makes one fused SGD update
W, ROWS = 4, 16


def _runner():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1)
    state = TrainState(model, sgd_torch(model), lambda s: 0.01)
    rng = np.random.default_rng(0)
    ds = DeviceDataset(ArrayDataset(
        rng.integers(0, 256, (ROWS, 1, 1, 3), dtype=np.uint8),
        np.zeros(ROWS, np.int32)), device="cpu")

    def step_by_index(state, idx, sched, draws, inject=None, shared=None):
        images, _ = ds.gather(idx)
        x = images.flatten(1).float() / 255.0
        noise = torch.rand(x.shape, generator=draws.generator("cpu"))
        loss = draws.beta(1.0, 1.0) * (model(x + noise) ** 2).mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return state, ChunkRunner(step_by_index, "cpu", steps=2, width=W)


def _epoch(state, runner, epoch: int, steps: int = 5):
    for c0 in range(0, steps, runner.steps):
        n = min(runner.steps, steps - c0)
        idx = np.stack([(np.arange(W) + c0 + j) % ROWS for j in range(n)])
        gens = [(torch.Generator().manual_seed(100 * epoch + c0 + j), None)
                for j in range(n)]
        runner.run(state, idx, gens)


def _children(records, i: int) -> list:
    return [r.name for r in records if r.parent == i]


def test_chunk_runner_spans():
    state, runner = _runner()
    _profiled(lambda: _epoch(state, runner, 0))
    records = spans.recorded()
    names = _by_name(records)
    runs = names["chunk.run"]
    assert [records[i].counts for i in runs] == [
        {"steps": 2}, {"steps": 2}, {"steps": 1}]
    # the first chunk: its index copy, then the eager steps
    assert _children(records, runs[0]) == ["chunk.copy_in", "chunk.eager"]
    assert records[names["chunk.eager"][0]].counts == {"steps": 2}
    # later chunks: both copies, the seeding, a capture of each new length
    # (the CPU's plain stand-in) and the replay
    for i in runs[1:]:
        assert _children(records, i) == [
            "chunk.copy_in", "chunk.seed", "chunk.copy_in", "chunk.capture",
            "chunk.replay"]
    assert [records[i].counts for i in names["chunk.capture"]] == [
        {"steps": 2}, {"steps": 1}]
    # int64 index rows, then float32 rows of weights and the rate
    copies = [records[i].counts["bytes"] for i in names["chunk.copy_in"]]
    assert copies == [2 * W * 8, 2 * W * 8, 2 * (LR + 1) * 4, W * 8,
                      (LR + 1) * 4]
    spans.clear()
    # a second traced epoch: every chunk a replay, no capture
    _profiled(lambda: _epoch(state, runner, 1))
    records = spans.recorded()
    names = _by_name(records)
    assert "chunk.capture" not in names and "chunk.eager" not in names
    for i in names["chunk.run"]:
        assert _children(records, i) == [
            "chunk.copy_in", "chunk.seed", "chunk.copy_in", "chunk.replay"]
    assert [records[i].counts for i in names["chunk.replay"]] == [
        {"steps": 2}, {"steps": 2}, {"steps": 1}]
    assert state.step == 10


def _vae():
    torch.manual_seed(0)
    return VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                  disc_latent_dim=K, device="cpu")


def test_classify_spans():
    api = ShotVaeInference(_vae(), device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    probs, _ = _profiled(lambda: api.classify(images))
    assert probs.shape == (3, K)
    records = spans.recorded()
    assert [(r.name, r.parent, r.counts) for r in records] == [
        ("serve.classify", None, {"images": 3}),
        ("serve.copy_in", 0, {"bytes": images.nbytes}),
        ("serve.forward", 0, {"images": 3})]


def test_eval_step_span():
    evaluate = make_vae_eval_step(_vae(), num_classes=K, bce=True,
                                  x_sigma=1.0)
    ds = DeviceDataset(ArrayDataset(
        np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                          dtype=np.uint8),
        np.arange(4, dtype=np.int32)), device="cpu")

    def run():
        img, lab = ds.gather(np.array([0, 2, 3]))
        return evaluate(img, lab, torch.ones(3),
                        generator=torch.Generator().manual_seed(1))

    (metrics, _), _ = _profiled(run)
    assert float(metrics["count"]) == 3.0
    assert [(r.name, r.parent, r.counts) for r in spans.recorded()] == [
        ("data.gather", None, {"rows": 3}), ("eval.step", None, {"rows": 3})]


def test_device_busy_is_a_union():
    """chip_smoke.py's busy time counts time covered by overlapping
    activity once (a sum of kernel times read an idle share below 0)."""
    assert chip_smoke.busy_ns([]) == 0
    assert chip_smoke.busy_ns([(10, 30), (20, 40), (60, 70), (65, 66),
                               (0, 5)]) == 45
