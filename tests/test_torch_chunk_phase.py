"""chip_smoke.py's phase 15 (``--steps-per-call`` as one CUDA graph of N
train steps) on the CPU at batch 2 with N = 2, where the chunk runner runs
its plain version: a path's replays against eager steps bit for bit with
no launch counted, two tiny epochs across the LR and ewm
boundaries in chunks of 2 against per-step dispatch; and the phase
failing a runner that freezes its first step's mixup weights into every
step of a chunk, and a replay whose launch counters do not move. One
replay a path here (CHUNK_REPLAYS, 3 in bf16 on the card): on the CPU every
replay of a chunk length takes the same path, and no launch is
counted.

Phase 16 (the same over a process group) likewise, over a gloo group of
one rank in this process: its paths' replays against eager group steps bit
for bit with the collectives of the replays equal to the eager steps'
(its launcher run needs the card); and the phase failing a runner that
leaves the shared generator's slots as the last step left them, and a
capture whose collectives are counted twice."""

import contextlib
import importlib.util
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N = 2, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.CHUNK_REPLAYS = {"bf16": 1, "f32": 1}
    return chip_smoke


def test_chip_smoke_chunk_phase_runs_on_cpu(monkeypatch, tmp_path):
    """Phase 15 on the CPU with its bf16 SHOT-VAE path alone (the M2 and
    classifier steps run through the runner in
    tests/test_torch_steps_per_call.py, the f32 SHOT-VAE path in the
    planted faults below): its chunked steps equal its eager steps bit
    for bit, no launch counted, finite metrics; two epochs of
    3 steps at batch 8 across the LR warm-up's end and the ewm bump, in
    chunks of 2 (a graph of 2 and one of 1), equal per-step dispatch bit
    for bit. (The epochs' TensorBoard writer is off: TensorBoard pulls in
    TensorFlow, which costs more than the epochs here.)"""
    from shotvae_torch.io.tb import TBWriter
    from shotvae_torch.train import loop

    monkeypatch.setattr(loop, "TBWriter",
                        lambda log_dir, enabled=True: TBWriter(log_dir,
                                                                False))
    chip_smoke = _chip_smoke()
    chip_smoke.CHUNK_PATHS = chip_smoke.CHUNK_PATHS[:1]
    assert chip_smoke.CHUNK_PATHS == (("shot_bf16", "shot", "bf16"),)
    boundary = dict(chip_smoke.CHUNK_BOUNDARY_CONFIG, batch_size=8,
                    synthetic_size=34, valid_per_class=1,
                    annotated_per_class=1)
    out = chip_smoke.chunk_phases(torch.device("cpu"), BATCH, N,
                                  str(tmp_path), "cpu", boundary=boundary,
                                  boundary_steps=2)
    for tag, _, _ in chip_smoke.CHUNK_PATHS:
        res = out[tag]
        assert set(res["launches"].values()) == {0}
        assert res["eager_vs_replay_bit_identical"]["steps"] == 2 * N
        assert all(math.isfinite(v) for v in res["last_metrics"].values())
    assert out["boundary"]["bit_identical"]
    assert out["boundary"]["steps"] == 6


def _frozen_weights(monkeypatch):
    """A runner that writes its first step's mixup weights into every
    step of a chunk, as a capture that froze them would replay."""
    from shotvae_torch.train import chunk

    write = chunk.ChunkRunner._write

    def frozen(self, state, n, generators):
        write(self, state, n, generators)
        self.scalars[1:n, :chunk.LR] = self.scalars[0, :chunk.LR]

    monkeypatch.setattr(chunk.ChunkRunner, "_write", frozen)


def _still_counters(monkeypatch):
    """A statistics wrapper that counts on the CPU as on the card, and
    replays that add no launch to the counters."""
    from shotvae_torch.ops.kernels import bn_leaky, count_launch
    from shotvae_torch.train import chunk

    plain = bn_leaky.bn_stats_plain

    def counting(x, eps=1e-5):
        count_launch(bn_leaky.bn_stats, x.dtype)
        return plain(x, eps)

    monkeypatch.setattr(bn_leaky, "bn_stats_plain", counting)
    monkeypatch.setattr(chunk, "add_counts", lambda made: None)


@pytest.mark.parametrize("fault,match", [
    ("frozen mixup weights", "metrics differ"),
    ("still counters", "moved the launch counters")])
def test_chip_smoke_chunk_phase_fails_a_planted_fault(fault, match,
                                                      monkeypatch):
    """Phase 15's f32 SHOT-VAE path at batch 2 with N = 2 on the CPU fails
    a chunk runner that reuses its first step's mixup weights for every
    step of a chunk, and replays whose launch counters do not move."""
    chip_smoke = _chip_smoke()
    if fault == "frozen mixup weights":
        _frozen_weights(monkeypatch)
    else:
        _still_counters(monkeypatch)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.chunk_path_phase(torch.device("cpu"), BATCH, N, "shot",
                                    None, 1, 0)


def _group_phase(chip_smoke, paths):
    """Phase 16 on the CPU over gloo at batch 2 with N = 2, one replay a
    path, the paths of ``paths``; no launcher run."""
    chip_smoke.GROUP_CHUNK_REPLAYS = 1
    chip_smoke.GROUP_CHUNK_PATHS = tuple(
        p for p in chip_smoke.GROUP_CHUNK_PATHS if p[0] in paths)
    assert [p[0] for p in chip_smoke.GROUP_CHUNK_PATHS] == list(paths)
    return chip_smoke.group_chunk_phases(torch.device("cpu"), BATCH, N, "",
                                         "cpu", cli=False)


def test_chip_smoke_group_chunk_phase_runs_on_cpu():
    """Phase 16's three paths over a gloo group of one rank: the sync-BN
    SHOT-VAE step, the per-replica one with global mixup and the sync-BN
    classifier step, each chunked against eager group steps bit for bit,
    no launch counted, the collectives of the replays equal to those of
    the eager steps and to the capture's, finite metrics."""
    paths = ("shot_sync_bf16", "shot_replica_global_mixup_bf16",
             "classifier_sync_bf16")
    out = _group_phase(_chip_smoke(), paths)
    for tag in paths:
        res = out[tag]
        assert set(res["launches"].values()) == {0}
        assert res["eager_vs_replay_bit_identical"]["steps"] == 2 * N
        coll = res["collectives"]
        assert coll["backend"] == "gloo" and coll["world_size"] == 1
        assert coll["replays"] == coll["eager_steps"] == \
            coll["captured_per_graph"] > 0
        assert all(math.isfinite(v) for v in res["last_metrics"].values())
    # sync-BN: two all-reduces a BN site; per replica: none there
    assert out["shot_sync_bf16"]["collectives"]["per_step"] > \
        out["shot_replica_global_mixup_bf16"]["collectives"]["per_step"]


def _stale_shared_slots(monkeypatch):
    """A runner that seeds each step's own generators and writes its rate,
    but leaves the shared generator's slots (its generators and weights)
    as the last step left them."""
    from shotvae_torch.train import chunk

    def write(self, state, n, generators):
        rows = self.scalars[:n].clone()
        for j, (gen, _) in enumerate(generators):
            self.draws[j].ensure(self.plan)
            lams = self.draws[j].seed(gen)
            rows[j, :len(lams)] = torch.tensor(lams)
            rows[j, chunk.LR] = self._rate(state, state.step + j)
        self.scalars[:n].copy_(rows)

    monkeypatch.setattr(chunk.ChunkRunner, "_write", write)


def _double_counted_collectives(monkeypatch):
    """A capture that counts each of its collectives twice."""
    from shotvae_torch.train import chunk

    held = chunk._held

    @contextlib.contextmanager
    def doubled(counts):
        with held(counts) as made:
            yield made
        counts["collectives"] *= 2

    monkeypatch.setattr(chunk, "_held", doubled)


@pytest.mark.parametrize("fault,match", [
    ("stale shared slots", "metrics differ"),
    ("collectives counted twice", "collectives")])
def test_chip_smoke_group_chunk_phase_fails_a_planted_fault(fault, match,
                                                            monkeypatch):
    """Phase 16's sync-BN SHOT-VAE path over a gloo group of one rank at
    batch 2 with N = 2 fails a runner that skips the re-seed of the shared
    generator's slots (the mixup weights and partners over the global
    batch), and a capture whose collectives are counted twice."""
    {"stale shared slots": _stale_shared_slots,
     "collectives counted twice": _double_counted_collectives}[fault](
        monkeypatch)
    with pytest.raises(RuntimeError, match=match):
        _group_phase(_chip_smoke(), ("shot_sync_bf16",))
