"""Several train steps per host dispatch (``--steps-per-call N``). Port of
shotvae_tpu/train/loop.py:54-116 (``_make_chunk_runner``, ``_chunk_keys``).

The JAX loop runs a chunk of N steps as one ``lax.scan`` in one jitted
call. Here, on a CUDA card, a chunk of N steps is one replay of a CUDA
graph that captured all N steps; on the CPU the runner runs the same N
steps one after another, its plain version. Either way a chunk's steps are
the steps of per-step dispatch: step i of an epoch draws from the host
generator (seed + 1000, epoch, i), the batches come in the same order, and
a chunk never straddles an epoch (the last one of an epoch may be shorter;
one graph per distinct length, as JAX compiles one scan per length).

A graph replays what it captured, so every value that changes from step
to step lives in a static buffer that the runner writes before each
replay, each with one copy from the host and none from inside the graph:
  * ``idx``: each step's (labeled | unlabeled) dataset indices, which the
    step gathers on the card (JAX's ``device_put`` of the index chunks);
  * ``scalars``: each step's mixup weights (``LAM_SLOTS``, drawn on the
    host) and its learning rate (the schedule at its global step), which
    the fused SGD update of that step reads as its ``lr`` tensor;
  * ``sched``: the epoch's loss weights, written once per epoch;
  * each step's persistent device generators (``sampling.StepDraws``),
    re-seeded on the host from the step's generator in the order the step
    draws and registered with every graph that uses them.
Each step writes its metrics into row j of ``out``, which the loop copies
after each replay and sums at the end of the epoch as JAX sums the (n,)
per-step scalars.

The first chunk a runner sees runs eagerly (on its capture stream, on the
card), drawing as it goes: these are real steps of the run. They create
SGD's momentum buffers, compile every Triton kernel, set the fused conv's
first-call attributes and allocate the ``bn_leaky`` ticket counters of the
capture stream, none of which may happen inside a capture; and they record
the order of the draws that each later chunk re-seeds. A runner is made
after any restore of a checkpoint, so no graph holds a momentum buffer
that ``load_state_dict`` has replaced. A wrapper counts its launches in
Python, so a capture counts the launches of its N steps, takes them back
out (nothing was launched) and adds them at each replay; chip_smoke.py
holds these counts against the kernel nodes of each captured graph.
Nothing falls back: a failed capture or replay raises.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from shotvae_torch.ops.kernels import add_counts, held_counts
from shotvae_torch.ops.sampling import LAM_SLOTS, StepDraws
from shotvae_torch.train.state import TrainState

LR = LAM_SLOTS  # the column of ``scalars`` that holds a step's rate


class _Graph:
    """A captured chunk of ``n`` steps and the launches its capture
    counted."""

    def __init__(self, graph, n: int, launches: dict):
        self.graph, self.n, self.launches = graph, n, launches

    def replay(self, state: TrainState, injects) -> None:
        del injects  # the graph holds its steps' draws
        self.graph.replay()
        state.step += self.n


class _PlainGraph:
    """The CPU's stand-in for a captured chunk: its deferred steps run one
    after another, reading the static inputs as a replay would. The
    launches its first run counted are its own, as a capture's are."""

    def __init__(self, runner: "ChunkRunner", n: int):
        self.runner, self.n, self.launches = runner, n, None

    def replay(self, state: TrainState, injects) -> None:
        with held_counts() as made:
            self.runner._deferred_steps(state, self.n, injects)
        if self.launches is None:
            self.launches = made


class ChunkRunner:
    """Runs chunks of up to ``steps`` train steps of ``step_by_index(state,
    idx, sched, draws, inject) -> {metric: 0-d tensor}`` on ``device``:
    ``idx`` is a (``width``,) int64 index row on the device, ``sched`` the
    dict of the epoch's 0-d float32 loss weights (None where the step
    takes none), ``draws`` the step's ``StepDraws`` and ``inject`` its
    injected draws (the plain version only; None on the card)."""

    def __init__(self, step_by_index: Callable, device, *, steps: int,
                 width: int):
        self.step_by_index = step_by_index
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and not hasattr(torch.cuda.CUDAGraph,
                                     "register_generator_state"):
            raise RuntimeError(
                "this torch's CUDAGraph has no register_generator_state, "
                "which a graph of train steps needs for its generators")
        self.steps = steps
        self.idx = torch.zeros((steps, width), dtype=torch.int64,
                               device=self.device)
        self.scalars = torch.zeros((steps, LAM_SLOTS + 1),
                                   dtype=torch.float32, device=self.device)
        self.draws = [StepDraws(self.device, lams=self.scalars[j, :LR])
                      for j in range(steps)]
        self.sched: Optional[dict] = None
        self._sched_buf: Optional[torch.Tensor] = None
        self.keys: Optional[List[str]] = None
        self.out: Optional[torch.Tensor] = None
        self.plan: Optional[list] = None
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
            generators: Sequence[torch.Generator],
            injects: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """One chunk: ``len(generators)`` steps of ``state`` on the index
        rows ``idx`` ((n, width)), step j drawing from ``generators[j]``.
        Returns the (n, len(keys)) float32 metrics, a copy on the
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
        return self.out[:n].clone()

    def _injected(self, injects, j: int):
        return None if injects is None else injects[j]

    def _store(self, j: int, metrics: dict) -> None:
        if self.keys is None:
            self.keys = list(metrics)
            self.out = torch.zeros((self.steps, len(self.keys)),
                                   dtype=torch.float32, device=self.device)
        self.out[j].copy_(torch.stack([metrics[k].to(torch.float32)
                                       for k in self.keys]))

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.cuda else nullcontext()

    def _warm_up(self, state, n: int, generators, injects) -> None:
        """The first chunk, eagerly, each step drawing as it goes; records
        the order of the draws."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            for j in range(n):
                self._store(j, self.step_by_index(
                    state, self.idx[j], self.sched,
                    self.draws[j].draw(generators[j]),
                    self._injected(injects, j)))
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        plans = [self.draws[j].plan for j in range(n)]
        if any(p != plans[0] for p in plans):
            raise RuntimeError(f"the steps of a chunk drew in different "
                               f"orders: {plans}")
        self.plan = plans[0]

    def _rate(self, state: TrainState, step: int) -> float:
        if state.lr_schedule is None:
            return state.optimizer.param_groups[0]["lr"]
        return state.lr_schedule(step)

    def _write(self, state: TrainState, n: int, generators) -> None:
        """Seed each step's generators and write its mixup weights and its
        rate (one copy)."""
        rows = np.zeros((n, LAM_SLOTS + 1), np.float32)
        for j in range(n):
            self.draws[j].ensure(self.plan)
            lams = self.draws[j].seed(generators[j])
            rows[j, :len(lams)] = lams
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
                self._store(j, self.step_by_index(
                    state, self.idx[j], self.sched, self.draws[j].defer(),
                    self._injected(injects, j)))
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
        for draws in self.draws[:n]:
            for gen in draws.generators:
                graph.register_generator_state(gen)
        step = state.step
        try:
            with held_counts() as launches:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self.stream):
                    self._deferred_steps(state, n, injects)
        finally:
            state.step = step  # the capture ran no step
        if self._pool is None:
            self._pool = graph.pool()
        self.graphs[n] = _Graph(graph, n, launches)
        torch.cuda.synchronize(self.device)
        self.capture_s[n] = time.perf_counter() - t0
        return self.graphs[n]
