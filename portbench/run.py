"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card. The cell's
configuration, traffic mix and per-layer metrics are found by name
(``portbench/lib/cells.py``). With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from a traced window. Every run checks what its timed path produced
against the plain reference (``portbench/reference``) and prints each
compared number beside its limit, last on standard error and last in the
result line. A run with no card, or one that finds the JAX package or JAX
loaded, prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "shotvae_tpu"}


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = process_start()


def caches(root: Path = ROOT) -> None:
    """Every compile cache at a fixed folder inside the checkout, set
    before torch or the port is imported."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def fail(code: str, message: str, status: int = 2):
    print(json.dumps({"error": code, "message": message}), file=sys.stderr)
    sys.exit(status)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, dev, t_start: float = T_START):
    """Drive ``cell`` on ``dev`` and build its result: (result dict,
    {compared name: [number, limit]})."""
    import torch

    from portbench.lib import cells, check
    from portbench.lib.trace import breakdown
    from portbench.lib.view import View

    drv = cells.driver(cell.traffic["kind"], cell.root)
    run = drv.drive(cell, dev, t_start)
    correct, table = check.judge(drv.numbers(run), cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if cell.trace:
        view = View(cell, run)
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(run["metrics"], setup_s=run["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1,
              "memory_peak_bytes": run.get("memory_peak_bytes", 0)}
    result = {"correct": bool(correct), "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        trace = run["trace"]
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = breakdown(trace)
    result["checked"] = table
    return result, table


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    sys.path.insert(0, str(ROOT))
    try:
        import torch
    except ImportError as exc:
        fail("no_torch", str(exc))
    from portbench.lib import cells

    torch.set_num_threads(2)  # the host's part is a few small draws
    try:
        cell = cells.find(args.workload)
    except (OSError, KeyError) as exc:
        fail("no_workload", str(exc))
    if not torch.cuda.is_available():
        fail("no_card", "torch.cuda.is_available() is false: this benchmark "
             "measures the port on an NVIDIA card and has no CPU fallback")
    if torch.cuda.device_count() < cell.workload["chips"]:
        fail("too_few_cards", f"{torch.cuda.device_count()} cards; the cell "
             f"asks for {cell.workload['chips']}")
    try:
        import shotvae_torch  # noqa: F401
    except ImportError as exc:
        fail("no_program", f"the port is not importable: {exc}")
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)
    result, table = run_cell(cell, torch.device("cuda", 0))
    found = loaded_forbidden()
    if found:
        fail("jax_loaded", f"modules loaded in this process: {found}", 3)
    for name, (value, limit) in table.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
