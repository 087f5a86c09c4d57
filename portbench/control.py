"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size:

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \\
        [--faults half decoder+padding] [--trunk float32] \\
        [--out chiprun_out/control.jsonl]

For each seed, one JSON line with the compared numbers of
  * ``program``: the program's timed path (set-up and one window epoch, as a
    run makes them) against the plain reference at the configuration's
    precision: the lower reading;
  * ``control``: the plain reference one precision below (train: fp8
    operands for the bfloat16 trunk; serve: TF32 for float32) against the
    same reference: the upper reading where it is three times the lower;
  * each planted fault of ``--faults`` against the reference (train:
    ``half``, half of each stream left out, the loss a mean over the rest;
    ``frozen``, steps that leave their state unchanged; ``decoder``, the
    decoder's weight gradients halved; ``padding``, the eval pass counting
    its padding rows; serve: ``altered``, one answer altered where it is
    produced; faults that touch different numbers join with ``+``);
and, for the train numbers, each module group's median leaf gap and the
three worst leaves. ``--trunk float32`` runs the program and the reference
with a float32 trunk instead (the witness that two sound computations
agree leaf by leaf there). Seeds run one after another in one process. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STATE = ("grad", "change", "momentum")


def diagnosis(prog: dict, ref: dict, top: int = 3) -> dict:
    """Of a train reading: each state number's group medians and worst
    leaves, and each eval sum's relative gap beside the reference's sum."""
    from portbench.lib import check

    if not isinstance(prog, dict) or "grad" not in prog:
        return {}
    out = {}
    for key in STATE:
        gaps = check.leaf_gaps(prog[key], ref[key], sorted(ref[key]))
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        out[key] = {"groups": check.group_medians(gaps), "worst": worst}
    out["eval"] = {k: [abs(prog["eval"][k] - v) / abs(v), v]
                   for k, v in ref["eval"].items()}
    return out


def readings(cell, dev, faults) -> dict:
    import torch

    from portbench.lib import cells

    drv = cells.driver(cell.traffic["kind"], cell.root)
    out = {}
    for fault in [None] + list(faults):
        cell.fault = fault
        run = drv.drive(cell, dev, time.time())
        prog, ref = run["program"], run["reference"]
        out[fault or "program"] = dict(drv.numbers(run),
                                       diagnosis=diagnosis(prog, ref))
        if fault is None:
            low = drv.control(cell, dev, run)
            out["control"] = dict(
                drv.numbers({"program": low, "reference": ref}),
                diagnosis=diagnosis(low, ref))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    cell.fault = None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: one epoch for training; 4 s "
                        "for serving)")
    p.add_argument("--trunk", choices=("float32",), default=None,
                   help="train cells: a float32 trunk in the program and "
                        "the reference")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import caches
    caches()
    import torch

    from portbench.lib import cells

    cell = cells.find(args.workload)
    cell.seconds = (args.seconds if args.seconds is not None else
                    4.0 if cell.traffic["kind"] == "serve_closed" else 0.0)
    if args.trunk:
        cell.config["cli"]["bf16"] = False
        cell.config["precision"]["train_trunk"] = args.trunk
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        cell.seed = seed
        t0 = time.time()
        got = readings(cell, dev, args.faults)
        line = json.dumps({
            "workload": cell.name, "seed": seed,
            "trunk": cell.config["precision"]["train_trunk"], **got,
            "seconds": time.time() - t0,
            "host_peak_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
            "card_reserved_gb": torch.cuda.memory_reserved(dev) / 1e9})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
