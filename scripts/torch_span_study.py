#!/usr/bin/env python3
"""What the port's spans (``shotvae_torch/utils/spans.py``) cost and what
they reach, on one CUDA card.

    python3 scripts/torch_span_study.py [costs] [clock] [relaunch] \
        [cells SEED ...]

* ``costs``: host microseconds per span with no profiler (10**6 enter and
  exit pairs, the bare loop's time included) and under torch.profiler (CPU
  and CUDA activities; 20,000 spans less a bare loop under the same
  profiler);
* ``clock``: a kernel launched and synchronised inside a span, 300 times
  under the profiler: how far the kernel's device bounds lie outside the
  span's recorded bounds (``time.time_ns()``), in microseconds (at most 0:
  inside), and how far the record lies from its own ``sv:`` event;
* ``relaunch``: the host's time in ``CUDAGraph.replay()`` when the same
  graph, or another, is still running on the card, for a graph of few
  long kernels and one of thousands of short ones;
* ``cells``: each cell of ``BENCHMARK.json`` traced once for each seed,
  as ``portbench/run.py --trace 1`` traces it, and read from the same
  trace: the port's span metrics, the parts of ``chunk.run`` and
  ``serve.classify`` (host and device idle milliseconds in each child, per
  unit), how much of each parent the children cover, ``chunk.run``
  against the benchmark's own ``runner.run`` span, the spans a unit, and
  the share of the device's idle time inside the port's spans and inside
  each of the benchmark's spans.

Prints the card's name and power limit, then one JSON line per part (and
per cell and seed). With no argument: ``costs clock``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.run import caches  # noqa: E402

caches(ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from shotvae_torch.utils import spans  # noqa: E402

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return {"card": out.stdout.strip(), "torch": torch.__version__}


def costs() -> dict:
    span = spans.span
    n = 10**6
    t0 = time.perf_counter()
    for _ in range(n):
        with span("off", steps=1):
            pass
    off_us = (time.perf_counter() - t0) / n * 1e6
    m = 20_000
    with profile(activities=ACTIVITIES):
        with span("warm"):
            pass
        t0 = time.perf_counter()
        for _ in range(m):
            pass
        bare = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(m):
            with span("on", steps=1):
                pass
        on = time.perf_counter() - t0
    spans.clear()
    return {"part": "costs", "off_us_per_span": off_us, "off_pairs": n,
            "on_us_per_span": (on - bare) / m * 1e6, "on_spans": m}


def _spread(values, block: int) -> list:
    """[least, largest] of each block of ``block`` values, in order."""
    return [[min(values[i:i + block]), max(values[i:i + block])]
            for i in range(0, len(values), block)]


def clock(reps: int = 300, block: int = 50) -> dict:
    """Each of ``reps`` spans (8 ms apart) launches one matmul (about 1 ms)
    and synchronises; per block of ``block`` spans in order, [least,
    largest] of how far the kernel lies outside the span's recorded
    bounds (``device_us_outside``) and of how far the record's bounds lie
    from its own ``sv:`` event on the host (``host_us_apart``)."""
    from torch.autograd import DeviceType

    a = torch.randn(3072, 3072, device="cuda")
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(reps):
            with spans.span("clock"):
                a @ a
                torch.cuda.synchronize()
            time.sleep(0.006)
    records = [r for r in spans.recorded() if r.name == "clock"]
    events = prof.profiler.kineto_results.events()
    kernels = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.device_type() == DeviceType.CUDA
                     and not e.name().startswith(spans.PREFIX))
    host = sorted((e.start_ns(), e.end_ns()) for e in events
                  if e.device_type() == DeviceType.CPU
                  and e.name() == spans.PREFIX + "clock")
    spans.clear()
    if not (len(records) == len(host) == reps):
        return {"part": "clock", "error": f"{len(records)} records, "
                f"{len(host)} sv: events"}
    device = []
    for r in records:  # the kernels of a matmul: near its span alone
        near = [k for k in kernels
                if k[1] > r.start_ns - 1_000_000
                and k[0] < r.end_ns + 1_000_000]
        if not near:
            return {"part": "clock", "error": "a span with no kernel"}
        device.append(max(r.start_ns - min(k[0] for k in near),
                          max(k[1] for k in near) - r.end_ns) / 1e3)
    apart = [max(abs(r.start_ns - h[0]), abs(r.end_ns - h[1])) / 1e3
             for r, h in zip(records, host)]
    return {"part": "clock", "spans": reps, "block": block,
            "device_us_outside": _spread(device, block),
            "host_us_apart": _spread(apart, block),
            "device_max_after_first_block": max(device[block:])}


def _captured(work, generators=()) -> "torch.cuda.CUDAGraph":
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            work()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    for gen in generators:
        g.register_generator_state(gen)
    with torch.cuda.graph(g):
        work()
    torch.cuda.synchronize()
    return g


def relaunch(reps: int = 5) -> dict:
    """Host ms of ``graph.replay()`` for graphs of 40 matmuls, of 6,000
    and 20,000 small adds, and of 6,000 adds after a draw from each of 16
    registered generators (as a chunk's graph holds them): launched on an
    idle card, launched again while its previous replay runs, and a second
    graph of the same work launched while the first runs; medians of
    ``reps``."""
    import statistics

    a = torch.randn(3072, 3072, device="cuda")
    x = torch.zeros(1 << 16, device="cuda")

    def matmuls():
        b = a
        for _ in range(40):
            b = b @ a

    def adds(n=6000):
        for _ in range(n):
            x.add_(1.0)

    gens = [torch.Generator(device="cuda") for _ in range(16)]

    def drawn():
        for gen in gens:
            x.add_(torch.rand(x.shape, device="cuda", generator=gen))
        adds()

    out = {"part": "relaunch"}
    for label, work, registered in (
            ("matmuls_40", matmuls, ()), ("adds_6000", adds, ()),
            ("adds_20000", lambda: adds(20000), ()),
            ("adds_6000_gens_16", drawn, gens)):
        graphs = [_captured(work, registered) for _ in range(2)]
        times = {"idle": [], "same_running": [], "other_running": [],
                 "both": []}
        for _ in range(reps):
            for key, second in (("same_running", 0), ("other_running", 1)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graphs[0].replay()
                t1 = time.perf_counter()
                graphs[second].replay()
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                times["idle"].append((t1 - t0) * 1e3)
                times[key].append((t2 - t1) * 1e3)
                times["both"].append((time.perf_counter() - t0) * 1e3)
        out[label] = {k: statistics.median(v) for k, v in times.items()}
    return out


def _ms(ns: float) -> float:
    return ns / 1e6


def read_cell(cell, run) -> dict:
    """The port's span metrics and the extra readings of one traced run."""
    from portbench.lib import cells, program
    from portbench.lib.trace import union
    from portbench.lib.view import View

    view = View(cell, run)
    trace = view.trace
    metrics = {m["name"]: cells.reader(m["name"], cell.root)(view)
               for m in cell.per_layer}
    recs = program.records(view)
    every = [r for r, _ in recs]
    full = spans.recorded()
    window_ns = trace.window[1] - trace.window[0]
    idle_ns = window_ns - sum(e - s for s, e in trace.busy())
    out = {"metrics": metrics, "idle_ms": _ms(idle_ns),
           "window_s": trace.window_s, "records": len(every),
           "dropped": spans.dropped()}

    def parts(parent: str) -> dict:
        """Per unit of ``parent``: its host and idle ms, each child's, and
        the children's share of the parent's host time."""
        units = [r for r in every if r.name == parent]
        if not units:
            return {}
        ids = {id(r) for r in units}
        rows, covered = {}, 0
        for r in every:
            if r.parent is None or id(full[r.parent]) not in ids:
                continue
            s, e = r.start_ns, r.end_ns
            row = rows.setdefault(r.name, [0, 0, 0])
            row[0] += e - s
            row[1] += program.idle_ns(view, [(s, e)])
            row[2] += 1
            covered += e - s
        host = sum(r.end_ns - r.start_ns for r in units)
        n = len(units)
        below = sum(_under(full, r, ids) for r in every)
        return {"units": n, "host_ms": _ms(host / n),
                "idle_ms": _ms(program.idle_ns(
                    view, [(r.start_ns, r.end_ns) for r in units]) / n),
                "children": {k: {"host_ms": _ms(v[0] / n),
                                 "idle_ms": _ms(v[1] / n), "count": v[2]}
                             for k, v in rows.items()},
                "children_cover": covered / host if host else None,
                "spans_per_unit": 1 + below / n}

    out["chunk.run"] = parts("chunk.run")
    out["serve.classify"] = parts("serve.classify")
    out["eval.step"] = parts("eval.step")
    bench = {name: {"count": len(rows),
                    "host_ms": _ms(sum(e - s for s, e in rows) / len(rows)),
                    "idle_ms_total": _ms(program.idle_ns(view, rows))}
             for name, rows in trace.spans.items() if rows}
    out["bench_spans"] = bench
    top = [(r.start_ns, r.end_ns) for r, in_chunk in recs
           if r.parent is None or r.name == "data.gather" and not in_chunk]
    inside = program.idle_ns(view, union(top))
    out["idle_inside_port_spans"] = inside / idle_ns if idle_ns else None
    if "runner.run" in bench and out["chunk.run"]:
        out["chunk_run_over_runner_run"] = (out["chunk.run"]["host_ms"]
                                            / bench["runner.run"]["host_ms"])
    if "eval" in trace.spans:
        ev = program.intervals(view, ["eval.step", "data.gather"],
                               outside_chunks=True)
        n = len(program.intervals(view, ["eval.step"]))
        out["eval_idle_outside_port_spans_ms"] = _ms(
            (program.idle_ns(view, trace.spans["eval"])
             - program.idle_ns(view, ev)) / max(n, 1))
    return out


def _under(full, r, ids) -> bool:
    while r.parent is not None:
        r = full[r.parent]
        if id(r) in ids:
            return True
    return False


def run_cells(seeds) -> None:
    from portbench.lib import cells

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    dev = torch.device("cuda", 0)
    torch.set_num_threads(2)  # as portbench/run.py
    for w in bench["workloads"]:
        for seed in seeds:
            cell = cells.find(w["name"])
            cell.seed, cell.seconds, cell.trace = seed, 50.0, True
            drv = cells.driver(cell.traffic["kind"], cell.root)
            spans.clear()
            t0 = time.time()
            run = drv.drive(cell, dev, t0)
            line = {"part": "cell", "cell": w["name"], "seed": seed,
                    "counts": run["counts"]}
            line.update(read_cell(cell, run))
            print(json.dumps(line), flush=True)
            del run
            torch.cuda.empty_cache()


def main(argv) -> int:
    args = argv or ["costs", "clock"]
    print(json.dumps(card()), flush=True)
    if "costs" in args:
        print(json.dumps(costs()), flush=True)
    if "clock" in args:
        print(json.dumps(clock()), flush=True)
    if "relaunch" in args:
        print(json.dumps(relaunch()), flush=True)
    if "cells" in args:
        seeds = [int(a) for a in args[args.index("cells") + 1:]
                 if a.lstrip("-").isdigit()]
        run_cells(seeds or [2147483651])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
