"""Several train steps per host dispatch (``--steps-per-call N``). Port of
shotvae_tpu/train/loop.py:54-116 (``_make_chunk_runner``, ``_chunk_keys``),
with and without ``axis_name``.

The JAX loop runs a chunk of N steps as one ``lax.scan`` in one jitted
call, over the mesh where there is one. Here, on a CUDA card, a chunk of N
steps is one replay of a CUDA graph that captured all N steps; on the CPU
the runner runs the same N steps one after another, its plain version.
Either way a chunk's steps are the steps of per-step dispatch: step i of an
epoch draws from the host generators of (seed + 1000, epoch, i), the
batches come in the same order, and a chunk never straddles an epoch (the
last one of an epoch may be shorter; one graph per distinct length, as JAX
compiles one scan per length).

Over a process group (``parallel.DataParallel``, torchrun) each rank runs
its runner on its rows of every step, and each step draws from two host
generators: the rank's own (its rows' crops, flips, latent noise and
dropout) and the one every rank shares (mixup's weights and partners over
the global batch, the optimal match). A graph then holds the step's
collectives too: the sync-BN all-reduces between the hand kernels, the
gathers of the global mixup, the global KL means, the gradient and metric
means and, per replica, the running statistics' broadcast. On the card
this takes NCCL, which captures them (at world size 1 NCCL puts no node
of its own in the graph); a gloo group stages a CUDA tensor through the
host and cannot be captured, so it raises for N above 1 on a card. The
group's timeout does not cover a collective inside a replay (``parallel``).

A graph replays what it captured, so every value that changes from step
to step lives in a static buffer that the runner writes before each
replay, each with one copy from the host and none from inside the graph:
  * ``idx``: each step's (labeled | unlabeled) dataset indices of this
    rank's rows, which the step gathers on the card (JAX's ``device_put``
    of the index chunks);
  * ``scalars``: each step's mixup weights (``LAM_SLOTS`` of the rank's
    generator, then ``LAM_SLOTS`` of the shared one, drawn on the host)
    and its learning rate (the schedule at its global step), which the
    fused SGD update of that step reads as its ``lr`` tensor;
  * ``sched``: the epoch's loss weights, written once per epoch;
  * each step's persistent device generators (``sampling.StepDraws``, one
    for each host generator), re-seeded on the host from the step's
    generators, each in the order the step draws from it, and registered
    with every graph that uses them.
Each step writes its metrics into row j of ``out``, which the loop copies
after each replay and sums at the end of the epoch as JAX sums the (n,)
per-step scalars.

The first chunk a runner sees runs eagerly (on its capture stream, on the
card), drawing as it goes: these are real steps of the run. They create
SGD's momentum buffers, compile every Triton kernel, set the fused conv's
first-call attributes, allocate the ``bn_leaky`` ticket counters of the
capture stream and make the group's NCCL communicator, none of which may
happen inside a capture; and they record the order of the draws that each
later chunk re-seeds. Before a capture over a group every rank
synchronises its card and meets the others at a barrier, so that no eager
collective is in flight while the capture runs, and all capture the same
collectives in the same order. A runner is made after any restore of a
checkpoint, so no graph holds a momentum buffer that ``load_state_dict``
has replaced. A wrapper counts its launches in Python, and
``DataParallel`` its collectives, so a capture counts the launches and
collectives of its N steps, takes them back out (nothing ran) and adds
them at each replay; chip_smoke.py holds these counts against the kernel
nodes of each captured graph and the collectives against eager steps'.
Nothing falls back: a failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from shotvae_torch.ops.kernels import add_counts, held_counts
from shotvae_torch.ops.sampling import LAM_SLOTS, StepDraws
from shotvae_torch.parallel.mesh import DataParallel
from shotvae_torch.train.state import TrainState

SHARED = slice(LAM_SLOTS, 2 * LAM_SLOTS)  # the shared generator's weights
LR = 2 * LAM_SLOTS  # the column of ``scalars`` that holds a step's rate


def check_capturable(dp: Optional[DataParallel], device) -> None:
    """Raise where the steps of ``dp``'s group on ``device`` cannot be
    captured in a CUDA graph: a gloo group stages each CUDA tensor of a
    collective through the host, and NCCL's blocking wait
    (``TORCH_NCCL_BLOCKING_WAIT``) polls each collective's event from the
    host, which a capture forbids."""
    if (torch.device(device).type != "cuda" or dp is None
            or dp.group is None):
        return
    if dp.backend != "nccl":
        raise ValueError(
            f"--steps-per-call above 1 over a {dp.backend} group on a CUDA "
            f"card: its collectives stage through the host and cannot be "
            f"captured in a CUDA graph; use the NCCL backend (torchrun's "
            f"default for CUDA), or --steps-per-call 1")
    if os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0").lower() in ("1",
                                                                 "true"):
        raise ValueError(
            "--steps-per-call above 1 with TORCH_NCCL_BLOCKING_WAIT set: "
            "each NCCL collective would wait on the host inside a CUDA "
            "graph's capture; unset it, or use --steps-per-call 1")


@contextlib.contextmanager
def _held(counts: dict):
    """The launches (``held_counts``) and ``DataParallel`` collectives
    counted inside, taken back out on leaving and then held in ``counts``
    under ``"launches"`` and ``"collectives"``."""
    before = DataParallel.collectives
    try:
        with held_counts() as counts["launches"]:
            yield counts
    finally:
        counts["collectives"] = DataParallel.collectives - before
        DataParallel.collectives = before


def _seeded(draws: StepDraws, plan: list, host) -> np.ndarray:
    """``draws``' generators seeded from ``host`` in ``plan``'s order: its
    ``LAM_SLOTS`` weights (0 past those the plan draws)."""
    draws.ensure(plan)
    lams = np.zeros(LAM_SLOTS, np.float32)
    drawn = draws.seed(host)
    lams[:len(drawn)] = drawn
    return lams


class _Graph:
    """A captured chunk of ``n`` steps and the launches and collectives
    its capture counted."""

    def __init__(self, graph, n: int, counts: dict):
        self.graph, self.n = graph, n
        self.launches, self.collectives = (counts["launches"],
                                           counts["collectives"])

    def replay(self, state: TrainState, injects) -> None:
        del injects  # the graph holds its steps' draws
        self.graph.replay()
        state.step += self.n


class _PlainGraph:
    """The CPU's stand-in for a captured chunk: its deferred steps run one
    after another, reading the static inputs as a replay would. The
    launches its first run counted are its own, as a capture's are."""

    def __init__(self, runner: "ChunkRunner", n: int):
        self.runner, self.n = runner, n
        self.launches = self.collectives = None

    def replay(self, state: TrainState, injects) -> None:
        with _held({}) as made:
            self.runner._deferred_steps(state, self.n, injects)
        if self.launches is None:
            self.launches, self.collectives = (made["launches"],
                                               made["collectives"])


class ChunkRunner:
    """Runs chunks of up to ``steps`` train steps of ``step_by_index(state,
    idx, sched, draws, inject, shared=...) -> {metric: 0-d tensor}`` on
    ``device``: ``idx`` is a (``width``,) int64 index row of this rank's
    rows on the device, ``sched`` the dict of the epoch's 0-d float32 loss
    weights (None where the step takes none), ``draws`` the step's
    ``StepDraws`` of its rank's generator, ``shared`` those of the
    generator every rank shares (None with no group) and ``inject`` its
    injected draws (the plain version only; None on the card). ``dp``: the
    ranks whose collectives the steps issue (None: one process)."""

    def __init__(self, step_by_index: Callable, device, *, steps: int,
                 width: int, dp: Optional[DataParallel] = None):
        check_capturable(dp, device)
        self.step_by_index = step_by_index
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dp = dp if dp is not None and dp.group is not None else None
        if self.cuda and not hasattr(torch.cuda.CUDAGraph,
                                     "register_generator_state"):
            raise RuntimeError(
                "this torch's CUDAGraph has no register_generator_state, "
                "which a graph of train steps needs for its generators")
        self.steps = steps
        self.idx = torch.zeros((steps, width), dtype=torch.int64,
                               device=self.device)
        self.scalars = torch.zeros((steps, LR + 1), dtype=torch.float32,
                                   device=self.device)
        self.draws = [StepDraws(self.device, lams=self.scalars[j, :LAM_SLOTS])
                      for j in range(steps)]
        self.shared = [StepDraws(self.device, lams=self.scalars[j, SHARED])
                       for j in range(steps)]
        self.sched: Optional[dict] = None
        self._sched_buf: Optional[torch.Tensor] = None
        self.keys: Optional[List[str]] = None
        self.out: Optional[torch.Tensor] = None
        self.plan: Optional[list] = None  # the rank's generator's draws
        self.shared_plan: Optional[list] = None  # the shared generator's
        self.graphs: dict = {}
        self.capture_s: dict = {}  # seconds of each length's capture
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._pool = None

    def set_sched(self, sched: Optional[dict]) -> None:
        """Write the epoch's loss weights into the static ``sched``."""
        if sched is None:
            self.sched = None
            return
        values = torch.tensor([float(v) for v in sched.values()],
                              dtype=torch.float32)
        if self._sched_buf is None:
            self._sched_buf = torch.zeros(len(sched), dtype=torch.float32,
                                          device=self.device)
            self._sched_keys = list(sched)
        if list(sched) != self._sched_keys:
            raise ValueError(f"sched keys {list(sched)}; the runner holds "
                             f"{self._sched_keys}")
        self._sched_buf.copy_(values, non_blocking=True)
        self.sched = dict(zip(self._sched_keys, self._sched_buf.unbind()))

    def run(self, state: TrainState, idx: np.ndarray,
            generators: Sequence[tuple],
            injects: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """One chunk: ``len(generators)`` steps of ``state`` on the index
        rows ``idx`` ((n, width)), step j drawing from the host generators
        ``generators[j]``: (the rank's, the shared one or None with no
        group). Returns the (n, len(keys)) float32 metrics, a copy on the
        device."""
        n = len(generators)
        if not 0 < n <= self.steps or len(idx) != n:
            raise ValueError(f"a chunk of {n} steps and {len(idx)} index "
                             f"rows; the runner takes 1 to {self.steps}")
        if injects is not None and self.cuda:
            raise ValueError("injected draws are host arrays, which a "
                             "captured graph cannot take: inject on the "
                             "CPU")
        if not all(g.get("fused") for g in state.optimizer.param_groups):
            raise TypeError("a chunk runner needs torch.optim.SGD with "
                            "fused=True (state.sgd_torch), whose update "
                            "reads its rate from a tensor")
        self.idx[:n].copy_(torch.from_numpy(np.asarray(idx, np.int64)),
                           non_blocking=True)
        if self.plan is None:
            self._warm_up(state, n, generators, injects)
        else:
            self._write(state, n, generators)
            graph = self.graphs.get(n) or self._capture(state, n, injects)
            graph.replay(state, injects)
            add_counts(graph.launches)
            DataParallel.collectives += graph.collectives
        return self.out[:n].clone()

    def _injected(self, injects, j: int):
        return None if injects is None else injects[j]

    def _step(self, state, j: int, draws, shared, injects) -> None:
        """Step j of the chunk, its metrics stored in row j of ``out``."""
        self._store(j, self.step_by_index(
            state, self.idx[j], self.sched, draws, self._injected(injects, j),
            shared=shared if self.dp is not None else None))

    def _store(self, j: int, metrics: dict) -> None:
        if self.keys is None:
            self.keys = list(metrics)
            self.out = torch.zeros((self.steps, len(self.keys)),
                                   dtype=torch.float32, device=self.device)
        self.out[j].copy_(torch.stack([metrics[k].to(torch.float32)
                                       for k in self.keys]))

    def _on_stream(self):
        if self.cuda:
            return torch.cuda.stream(self.stream)
        return contextlib.nullcontext()

    def _warm_up(self, state, n: int, generators, injects) -> None:
        """The first chunk, eagerly, each step drawing as it goes; records
        the order of the draws."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            for j, (gen, shared) in enumerate(generators):
                self._step(state, j, self.draws[j].draw(gen),
                           self.shared[j].draw(shared), injects)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.plan, self.shared_plan = (self._plan(pool[:n])
                                       for pool in (self.draws, self.shared))

    @staticmethod
    def _plan(draws) -> list:
        """The one order in which the steps of a chunk drew from one
        generator each."""
        plans = [d.plan for d in draws]
        if any(p != plans[0] for p in plans):
            raise RuntimeError(f"the steps of a chunk drew in different "
                               f"orders: {plans}")
        return plans[0]

    def _rate(self, state: TrainState, step: int) -> float:
        if state.lr_schedule is None:
            return state.optimizer.param_groups[0]["lr"]
        return state.lr_schedule(step)

    def _write(self, state: TrainState, n: int, generators) -> None:
        """Seed each step's generators, each from its host generator in
        its own plan's order, and write its mixup weights and its rate
        (one copy)."""
        rows = np.zeros((n, LR + 1), np.float32)
        for j, (gen, shared) in enumerate(generators):
            rows[j, :LAM_SLOTS] = _seeded(self.draws[j], self.plan, gen)
            rows[j, SHARED] = _seeded(self.shared[j], self.shared_plan,
                                      shared)
            rows[j, LR] = self._rate(state, state.step + j)
        self.scalars[:n].copy_(torch.from_numpy(rows), non_blocking=True)

    def _deferred_steps(self, state: TrainState, n: int, injects) -> None:
        """Steps 0..n-1 reading only the static inputs: their draws
        deferred, their rates from ``scalars``."""
        groups = state.optimizer.param_groups
        schedule, rates = state.lr_schedule, [g["lr"] for g in groups]
        state.lr_schedule = None
        try:
            for j in range(n):
                for group in groups:
                    group["lr"] = self.scalars[j, LR]
                self._step(state, j, self.draws[j].defer(),
                           self.shared[j].defer(), injects)
        finally:
            state.lr_schedule = schedule
            for group, rate in zip(groups, rates):
                group["lr"] = rate

    def _new_graph(self) -> torch.cuda.CUDAGraph:
        return torch.cuda.CUDAGraph()

    def _capture(self, state: TrainState, n: int, injects):
        """The graph of a chunk of ``n`` steps: captured on the card (its
        launches counted and taken back out), the plain stand-in on the
        CPU."""
        if not self.cuda:
            graph = self.graphs[n] = _PlainGraph(self, n)
            return graph
        t0 = time.perf_counter()
        graph = self._new_graph()
        for draws in self.draws[:n] + self.shared[:n]:
            for gen in draws.generators:
                graph.register_generator_state(gen)
        if self.dp is not None:  # no eager collective in flight
            torch.cuda.synchronize(self.device)
            self.dp.barrier()
            torch.cuda.synchronize(self.device)
        step, counts = state.step, {}
        try:
            with _held(counts):
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self.stream):
                    self._deferred_steps(state, n, injects)
        finally:
            state.step = step  # the capture ran no step
        if self._pool is None:
            self._pool = graph.pool()
        self.graphs[n] = _Graph(graph, n, counts)
        torch.cuda.synchronize(self.device)
        self.capture_s[n] = time.perf_counter() - t0
        return self.graphs[n]
