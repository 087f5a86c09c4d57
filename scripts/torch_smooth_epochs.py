#!/usr/bin/env python3
"""Several epochs of the smooth-ELBO trainers' CLIs, step by step, on the
CUDA card and on the host CPU, to see where the card's losses leave the
CPU's.

    python3 scripts/torch_smooth_epochs.py [EPOCHS] [SEEDS...]
    python3 scripts/torch_smooth_epochs.py band [SEEDS...]

For MNIST and SVHN, each seed (default 1 2 3) and EPOCHS (default 3),
``python -m shotvae_torch.cli.main_smooth_elbo_<dataset> --synthetic-data
--max-epochs EPOCHS --seed S`` runs through the command's ``main`` three
ways: on the card as it stands (``exact``, float32 in full float32), on the
card with TF32 let into every train step's convolutions as PyTorch's
default allows (``tf32``: the arithmetic of the entry points before they
pinned float32), and on the CPU (``cpu``). Each run prints one JSON line:
every epoch's average loss and ``u_recon`` as the CLI logs them, and every
train step's loss of epoch 1 (read after each step). The card's name and
power limit come first, then how far one float32 convolution on the card
lies from float64 with TF32 on and inside ``exact_f32``; a last line
holds, per dataset and way, the epoch-1 average losses over the seeds.

``band`` needs no card: it runs, on the CPU, the two configurations of
``chip_smoke.py``'s phase 12 (MNIST on its written idx files, SVHN
through the synthetic fallback, each at the CLI's defaults) for two
epochs at each seed (default 1 to 5), and prints every seed's average
losses and, per configuration, the band of the epoch-1 average losses
that phase 12 holds the card's run inside.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def step_losses(record: list, tf32: bool):
    """Inside, every smooth-ELBO train step the loop makes appends its
    loss to ``record``; with ``tf32`` each step runs with cuDNN's TF32
    on."""
    import torch

    from shotvae_torch.train import loop

    make = loop.make_smooth_elbo_train_step

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(state, *a, **kw):
            if tf32:
                saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = True
            try:
                metrics = step(state, *a, **kw)
            finally:
                if tf32:
                    torch.backends.cudnn.allow_tf32 = saved
            record.append(float(metrics["loss"]))
            return metrics

        return counted

    loop.make_smooth_elbo_train_step = wrapped
    try:
        yield
    finally:
        loop.make_smooth_elbo_train_step = make


def run(dataset: str, seed: int, epochs: int, way: str) -> dict:
    from shotvae_torch.cli import main_smooth_elbo_mnist as cli

    record: list = []
    base = tempfile.mkdtemp(prefix=f"smooth_{dataset}_",
                            dir=os.path.join(ROOT, "build"))
    argv = ["-bp", base, "--synthetic-data", "--max-epochs", str(epochs),
            "--seed", str(seed)]
    try:
        with step_losses(record, tf32=way == "tf32"), \
                contextlib.redirect_stdout(open(os.devnull, "w")):
            out = cli.run(dataset == "svhn", argv,
                          device="cpu" if way == "cpu" else "cuda")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    history = out["history"]
    per_epoch = len(record) // len(history)
    return {"dataset": dataset, "seed": seed, "way": way,
            "mean_loss": [h["mean_loss"] for h in history],
            "u_recon": [h["train_terms"]["u_recon"] for h in history],
            "test_acc": [h["test_acc"] for h in history],
            "steps_per_epoch": per_epoch,
            "epoch1_step_losses": record[per_epoch:2 * per_epoch]}


def tf32_probe() -> dict:
    """The largest relative error of one float32 3x3 convolution on the
    card against float64 on the host: with cuDNN's TF32 on, and inside
    ``exact_f32`` (TF32 on outside it)."""
    import torch
    import torch.nn.functional as F

    from shotvae_torch.device import exact_f32

    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 64, 16, 16), generator=g)
    w = torch.randn((64, 64, 3, 3), generator=g)
    want = F.conv2d(x.double(), w.double(), padding=1)
    scale = float(want.abs().max())
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    out = {}
    try:
        for name, ctx in (("tf32_on", contextlib.nullcontext()),
                          ("exact_f32", exact_f32())):
            with ctx:
                got = F.conv2d(x.cuda(), w.cuda(), padding=1).cpu().double()
            out[name] = float((got - want).abs().max()) / scale
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def cpu_band(seeds) -> dict:
    """Phase 12's two configurations on the CPU, two epochs each seed:
    {dataset: [epoch-1 average loss per seed]}."""
    import chip_smoke as cs
    from shotvae_torch.train.loop import run_smooth_elbo

    bands: dict = {}
    for dataset in ("mnist", "svhn"):
        for seed in seeds:
            base = tempfile.mkdtemp(prefix=f"band_{dataset}_",
                                    dir=os.path.join(ROOT, "build"))
            try:
                argv = ["--seed", str(seed)]
                if dataset == "mnist":
                    cfg = cs.smooth_config(base, dataset, argv)
                    cs.write_mnist_idx(cfg.path_to_data,
                                       cs.SMOOTH_MNIST_SIZES)
                else:
                    cfg = cs.smooth_config(base, dataset,
                                           ["--synthetic-data", *argv])
                out = run_smooth_elbo(cfg, dataset, max_epochs=2,
                                      log_fn=lambda *a: None, device="cpu")
            finally:
                shutil.rmtree(base, ignore_errors=True)
            losses = [h["mean_loss"] for h in out["history"]]
            print(json.dumps({"dataset": dataset, "seed": seed,
                              "mean_loss": losses}), flush=True)
            bands.setdefault(dataset, []).append(losses[1])
    return {k: {"epoch1_mean_loss": v, "band": [min(v), max(v)]}
            for k, v in bands.items()}


def main() -> int:
    import torch

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    if sys.argv[1:2] == ["band"]:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
        seeds = [int(s) for s in sys.argv[2:]] or [1, 2, 3, 4, 5]
        print(json.dumps(cpu_band(seeds)))
        return 0
    if not torch.cuda.is_available():
        print("torch_smooth_epochs.py: torch sees no CUDA card",
              file=sys.stderr)
        return 1
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    seeds = [int(s) for s in sys.argv[2:]] or [1, 2, 3]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    print(json.dumps({"conv_rel_err_vs_f64": tf32_probe()}))
    bands: dict = {}
    for dataset in ("mnist", "svhn"):
        for way in ("exact", "tf32", "cpu"):
            for seed in seeds:
                res = run(dataset, seed, epochs, way)
                print(json.dumps(res))
                if len(res["mean_loss"]) > 1:
                    bands.setdefault(f"{dataset}_{way}", []).append(
                        res["mean_loss"][1])
    print(json.dumps({"epoch1_mean_loss": bands}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
