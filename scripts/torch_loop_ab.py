#!/usr/bin/env python3
"""The training loop's own cost on one CUDA card: the bf16 SHOT-VAE train
step alone against one epoch of ``run_shot_vae``, in turns in one process,
so that the host's speed, which sets the step's time, is shared.

    python3 scripts/torch_loop_ab.py [ROUNDS]

Each round (default 3) prints three JSON lines, at WRN-28-2, 768 + 768,
bf16, ``--br --om``:

* ``step_synced``: the step as ``chip_smoke.py``'s phase 6 times it (seeded
  random weights and data, the median and range of 10 steps after 2, each
  ending in a device synchronise), with unlabeled images/s at the median;
* ``step_back_to_back``: the same step 58 times with one synchronise at the
  end, the loop's epoch length without the loop;
* ``loop_epoch``: one epoch of ``run_shot_vae`` on 50,000 synthetic images
  (``chip_smoke.LOOP_CONFIG``: 58 steps, 25 eval forwards), its train part's
  seconds and unlabeled images/s, and its eval seconds;

then one JSON line of medians over the rounds. The card's name and power
limit come first.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def step_rates(steps: int) -> tuple:
    """(synced, back_to_back) of a fresh bf16 step of the headline model."""
    import torch

    dev = torch.device("cuda")
    model = cs.random_model("cuda", torch.bfloat16)
    state, step, sched = cs.trainer(model)
    g = torch.Generator().manual_seed(cs.SEED + 9)
    b = cs.BATCH
    data = [torch.randint(0, 256, (b, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(dev),
            (torch.arange(b) % 10).to(dev),
            torch.randint(0, 256, (b, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(dev),
            torch.randint(0, 10, (b,), generator=g).to(dev)]
    run = lambda: step(state, *data, sched, g)  # noqa: E731
    synced = cs.step_times(dev, run, b, "")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return synced, {"seconds": seconds, "steps": steps,
                    "unlabeled_images_per_s": steps * b / seconds}


def loop_epoch() -> dict:
    import torch

    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.train.loop import run_shot_vae

    base = tempfile.mkdtemp(prefix="loop_ab_",
                            dir=os.path.join(ROOT, "build"))
    try:
        out = run_shot_vae(ShotVaeConfig(base_path=base, **cs.LOOP_CONFIG),
                           max_epochs=1, log_fn=lambda *a: None,
                           device=torch.device("cuda"))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    times = out["epoch_times"][0]
    return {"epoch_s": out["history"][0]["seconds"],
            "train_s": times["train_s"], "eval_s": times["eval_s"],
            "unlabeled_images_per_s": cs.LOOP_STEPS * cs.BATCH
            / times["train_s"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_loop_ab.py: torch sees no CUDA card", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    from shotvae_torch.ops.kernels import _build

    _build.build_all()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    loop_epoch()  # compiles every kernel variant of the epoch
    rates = {"step_synced": [], "step_back_to_back": [], "loop_epoch": []}
    for r in range(rounds):
        synced, back_to_back = step_rates(cs.LOOP_STEPS)
        epoch = loop_epoch()
        for name, row in (("step_synced", synced),
                          ("step_back_to_back", back_to_back),
                          ("loop_epoch", epoch)):
            print(f"{name} round {r} " + json.dumps(row))
            rates[name].append(row["unlabeled_images_per_s"])
    print("median_unlabeled_images_per_s " + json.dumps(
        {k: statistics.median(v) for k, v in rates.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
