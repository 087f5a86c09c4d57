#!/usr/bin/env python3
"""The system run of the PyTorch port: the CIFAR-10(4k) 600-epoch recipe on
the CUDA card, killed mid-flight and resumed. The port's counterpart of
scripts/run_repro.py.

    python3 scripts/torch_run_repro.py --synthetic [--kill-epoch 300] \\
        [--epochs 600] [--steps-per-call 8] [--base-path BP]
    python3 scripts/torch_run_repro.py --synthetic --resume-at REASON ...

``--synthetic`` runs the composed recipe at full scale on synthetic data
(50,000 train images, 4,000 labels, batch 768 + 768, ``--br --om``, the
warm-up epoch 0, milestones 400/500/550, the ewm x5 bump at 400,
per-epoch checkpoints, best-after-last-milestone saves) and checks the
system rather than accuracy:

* phase 1 runs ``python -m shotvae_torch.cli.main_shot_vae`` as a child
  process and SIGKILLs it once its log reads epoch ``--kill-epoch``; the
  kill point is the epoch inside the checkpoint that ``checkpoint.current``
  names (the async writer may have been mid-write). Phase 1's record is
  written to ``<checkpoint folder>.phase1.json``;
* a probe resumes twice from the kill point, two epochs each, the
  checkpoint folder restored between them, and compares every tensor of
  the model's state_dict (parameters and BN buffers), the optimizer's
  state and the step count bit for bit;
* phase 2 resumes from the kill point and runs to the last epoch.

The JSON verdict (``<base-path>/repro_synthetic.json``) has the JAX
script's keys with their meaning (NaN-freeness, how flat the epoch times
are, the analytic LR trace, the checkpoint files) plus ``device`` (the
card's name and power limit), ``steps_per_call``, the train and eval
parts' epoch-second medians in ``phase2``, and
``lr_trace_matches_port_schedule``: the analytic trace against
``shotvae_torch.ops.schedules.multistep_lr`` at the first step of each
listed epoch, within 1e-12 relative.

``--resume-at REASON`` skips phase 1 and takes the newest checkpoint
under ``--base-path`` as the kill point: with phase 1's record beside it
(a run split across two invocations) that record is the report's
``phase1``, REASON under ``continued_by``; without it, REASON is recorded
as ``phase1.interrupted_by``. With no checkpoint it fails (exit 1).

The JAX script's other mode, the recipe on the CIFAR-10 files with its
best test top-1 held against ``--target``, is not ported: ``--synthetic``
is required.

Runs on the card; ``--device cpu`` runs everything on the CPU (the tests'
small sizes).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LR_TRACE_EPOCHS = (0, 1, 399, 400, 499, 500, 549, 550)
# the CLI's ``main`` on the CPU, for ``--device cpu`` (the module form
# always takes the card)
CPU_CHILD = ("import sys; from shotvae_torch.cli import main_shot_vae; "
             "main_shot_vae.main(sys.argv[1:], device='cpu')")


def _expected_lr_trace(base_lr, milestones, epochs, gamma=0.1,
                       warmup_factor=0.2):
    """Per-epoch LR, the reference's semantics: lr * warmup_factor during
    epoch 0, MultiStepLR's decay at each milestone stepped at the epoch's
    END, so epoch m still trains at the undecayed rate and the decay is
    first used at epoch m + 1 (scripts/run_repro.py:40-52)."""
    out = []
    for e in range(epochs):
        lr = base_lr * (gamma ** sum(1 for m in milestones if e > m))
        out.append(lr * warmup_factor if e == 0 else lr)
    return out


def _device_block(device) -> dict:
    """scripts/torch_learning_quality.py's ``device`` block: the card's
    name and power limit, torch's and CUDA's versions."""
    spec = importlib.util.spec_from_file_location(
        "torch_learning_quality",
        os.path.join(HERE, "torch_learning_quality.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    block = module.device_block(device, None)
    block.pop("steps_per_call")
    return block


def _checkpoint_epoch(ckpt: str):
    """The epoch the checkpoint that ``<ckpt>.current`` names resumes at,
    or None where there is none."""
    import torch

    from shotvae_torch.io.checkpoint import resolve_checkpoint_path

    if not os.path.isfile(ckpt + ".current"):
        return None
    path = resolve_checkpoint_path(ckpt)
    return int(torch.load(path, map_location="cpu",
                          weights_only=True)["epoch"])


def _phase1(args, base: str, ckpt: str) -> dict:
    """Run the CLI as a child and SIGKILL it once it logs ``--kill-epoch``;
    its record."""
    flags = ["-bp", base, "--dataset", "Cifar10", "--net-name",
             args.net_name, "--br", "--om", "--epochs", str(args.epochs),
             "--yes", "--synthetic-data", "--synthetic-size",
             str(args.synthetic_size), "--steps-per-call",
             str(args.steps_per_call), "-b", str(args.batch_size), "--ldc",
             str(args.ldc)]
    flags += ["--no-bf16"] * args.no_bf16
    for flag in ("valid_per_class", "annotated_per_class"):
        if getattr(args, flag):
            flags += ["--" + flag.replace("_", "-"),
                      str(getattr(args, flag))]
    cmd = ([sys.executable, "-c", CPU_CHILD] if args.device == "cpu" else
           [sys.executable, "-m", "shotvae_torch.cli.main_shot_vae"]) + flags
    t0 = time.time()
    env = dict(os.environ, PYTHONUNBUFFERED="1")  # the kill's line latency
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    epochs, killed, tail = [], False, []
    try:
        for line in proc.stdout:
            tail = (tail + [line.rstrip()])[-20:]
            if line.startswith("Epoch ") and "valid top1" in line:
                epochs.append(int(line.split()[1].rstrip(":")))
                if epochs[-1] >= args.kill_epoch:
                    proc.send_signal(signal.SIGKILL)  # a real mid-flight kill
                    killed = True
                    break
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait()
    record = {"epochs_seen": len(epochs),
              "last_epoch": epochs[-1] if epochs else None,
              "sigkilled": killed, "seconds": time.time() - t0,
              "checkpoint_epoch": _checkpoint_epoch(ckpt),
              "partial_writes": sorted(
                  f for f in os.listdir(os.path.dirname(ckpt))
                  if f.endswith(".tmp")) if os.path.isdir(
                      os.path.dirname(ckpt)) else []}
    if not killed:
        record["log_tail"] = tail
    return record


def _host_state(state) -> dict:
    """Every tensor of the model's state_dict, of the optimizer's state and
    the step count, copied to the host."""
    sd = {f"model.{k}": v.detach().cpu().clone()
          for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            if hasattr(v, "detach"):
                sd[f"optimizer.{i}.{k}"] = v.detach().cpu().clone()
    sd["step"] = int(state.step)
    return sd


def _same(a: dict, b: dict) -> bool:
    import torch

    return set(a) == set(b) and all(
        torch.equal(a[k], b[k]) if hasattr(a[k], "dtype") else a[k] == b[k]
        for k in a)


def _run_synthetic(args) -> int:
    import numpy as np

    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.device import exact_f32
    from shotvae_torch.ops.schedules import multistep_lr
    from shotvae_torch.train.loop import run_shot_vae

    base = os.path.abspath(args.base_path)
    os.makedirs(base, exist_ok=True)
    report = {"status": "RAN_SYNTHETIC", "net": args.net_name,
              "epochs": args.epochs, "kill_epoch": args.kill_epoch}
    ckpt_dir = os.path.join(base, "Cifar10-SHOT-VAE", "parameter",
                            "train_time_1")
    ckpt = os.path.join(ckpt_dir, "checkpoint")
    phase1_path = ckpt_dir + ".phase1.json"

    if args.resume_at is not None:
        # continuation: the newest checkpoint is the kill point
        if _checkpoint_epoch(ckpt) is None:
            report["status"] = "NO_CHECKPOINT_TO_RESUME"
            print(json.dumps(report, indent=2))
            return 1
        if os.path.isfile(phase1_path):
            with open(phase1_path) as f:
                report["phase1"] = dict(json.load(f),
                                        continued_by=args.resume_at)
        else:
            report["phase1"] = {"epochs_seen": None,
                                "last_epoch": _checkpoint_epoch(ckpt),
                                "sigkilled": True,
                                "interrupted_by": args.resume_at,
                                "seconds": None}
    else:
        report["phase1"] = _phase1(args, base, ckpt)
        with open(phase1_path, "w") as f:
            json.dump(report["phase1"], f, indent=2)
        if not report["phase1"]["sigkilled"]:
            report["status"] = "PHASE1_DIED_EARLY"
            print(json.dumps(report, indent=2))
            return 1
    kill_point = _checkpoint_epoch(ckpt)
    if kill_point is None:
        report["status"] = "NO_CHECKPOINT_TO_RESUME"
        print(json.dumps(report, indent=2))
        return 1
    report["device"] = _device_block(args.device)
    report["steps_per_call"] = args.steps_per_call

    def make_cfg(**kw):
        return ShotVaeConfig(
            base_path=base, dataset="Cifar10", net_name=args.net_name,
            br=True, om=True, epochs=args.epochs, yes=True, ckpt_every=1,
            synthetic_data=True, synthetic_size=args.synthetic_size,
            steps_per_call=args.steps_per_call,
            batch_size=args.batch_size, ldc=args.ldc, bf16=not args.no_bf16,
            valid_per_class=args.valid_per_class,
            annotated_per_class=args.annotated_per_class, **kw)

    def run(cfg, **kw):
        with exact_f32():  # as the CLI runs
            return run_shot_vae(cfg, log_fn=lambda *a: None,
                                device=args.device, **kw)

    # the probe: two resumes of two epochs from the kill point, compared
    # bit for bit; its own saves would advance the checkpoint past the kill
    # point, so the folder is snapshotted and restored around each
    probe_to, steps_per_epoch = None, None
    if not args.skip_determinism_probe:
        snap = ckpt_dir + ".kill_snapshot"
        shutil.copytree(ckpt_dir, snap, dirs_exist_ok=True)
        states = []
        for _ in range(2):
            out = run(make_cfg(resume=ckpt), max_epochs=kill_point + 2)
            states.append(_host_state(out["state"]))
            probe_to = out["history"][-1]["epoch"]
            steps_per_epoch = out["state"].step // (probe_to + 1)
            del out
            gc.collect()  # the run's model and graphs, before the next
            shutil.rmtree(ckpt_dir)
            shutil.copytree(snap, ckpt_dir)
        shutil.rmtree(snap)
        report["double_resume_bit_exact"] = _same(*states)
        del states

    # phase 2: resume from the kill point, run to the last epoch
    t1 = time.time()
    cfg2 = make_cfg(resume=ckpt)
    base_ewm = cfg2.ewm  # the x5 bump is read against the pre-run value
    out = run(cfg2)
    hist = out["history"]
    secs = [h["seconds"] for h in hist]
    losses = [h["train_loss"] for h in hist]
    half = len(secs) // 2

    def median(v):
        return float(np.median(v)) if len(v) else None

    report["phase2"] = {
        "resumed_from_epoch": hist[0]["epoch"] if hist else None,
        "final_epoch": hist[-1]["epoch"] if hist else None,
        "seconds": time.time() - t1,
        "train_loss_first": losses[0] if losses else None,
        "train_loss_last": losses[-1] if losses else None,
        "nan_free": bool(losses) and all(math.isfinite(v) for v in losses),
        "epoch_seconds_median_first_half": median(secs[:half]) if half
        else None,
        "epoch_seconds_median_second_half": median(secs[half:]) if half
        else None,
        "epoch_seconds_p90": float(np.percentile(secs, 90)) if secs
        else None,
        "epoch_train_s_median": median([t["train_s"]
                                        for t in out["epoch_times"]]),
        "epoch_eval_s_median": median([t["eval_s"]
                                       for t in out["epoch_times"]]),
        "best_valid_top1": out["best_valid_acc"],
        "ewm_bumped_x5": bool(cfg2.ewm > 0.9 * 5 * base_ewm)
        if args.epochs > 400 else None,
    }
    if hist:
        steps_per_epoch = out["state"].step // (hist[-1]["epoch"] + 1)
    del out
    report["probe_resumed_through_epoch"] = probe_to
    trace = _expected_lr_trace(cfg2.lr, cfg2.adjust_lr, args.epochs)
    listed = [e for e in LR_TRACE_EPOCHS if e < args.epochs]
    report["lr_trace_epochs_0_1_399_400_499_500_549_550"] = [
        trace[e] for e in listed]
    port_lr = multistep_lr(cfg2.lr, cfg2.adjust_lr, steps_per_epoch or 1)
    report["lr_trace_matches_port_schedule"] = all(
        math.isclose(trace[e], port_lr(e * (steps_per_epoch or 1)),
                     rel_tol=1e-12) for e in listed)
    report["checkpoint_artifacts"] = sorted(os.listdir(ckpt_dir)) \
        if os.path.isdir(ckpt_dir) else []
    ok = (report["phase2"]["nan_free"]
          and report.get("double_resume_bit_exact", True)
          and report["phase2"]["final_epoch"] == args.epochs - 1
          and report["lr_trace_matches_port_schedule"])
    report["status"] = "OK" if ok else "CHECK_FAILED"
    with open(os.path.join(base, "repro_synthetic.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base-path", default=".")
    p.add_argument("--net-name", default="wideresnet-28-2")
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="the full recipe on synthetic data with a "
                        "mid-flight SIGKILL and resume (the system run; "
                        "the only mode ported)")
    p.add_argument("--kill-epoch", type=int, default=300)
    p.add_argument("--resume-at", default=None, metavar="REASON",
                   help="skip phase 1 and take the newest checkpoint under "
                        "--base-path as the kill point")
    p.add_argument("--synthetic-size", type=int, default=50000)
    p.add_argument("--batch-size", type=int, default=768,
                   help="per-stream batch (other values for small runs)")
    p.add_argument("--ldc", type=int, default=128)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--valid-per-class", type=int, default=0)
    p.add_argument("--annotated-per-class", type=int, default=0)
    p.add_argument("--skip-determinism-probe", action="store_true")
    p.add_argument("--steps-per-call", type=int, default=8,
                   help="train steps per dispatch, one CUDA graph (the same "
                        "in phase 1, the probe and phase 2)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from shotvae_torch.device import resolve_device

    resolve_device(args.device)  # raises where no card is seen
    return _run_synthetic(args)


if __name__ == "__main__":
    sys.exit(main())
