#!/usr/bin/env python3
"""Learning quality through the port: does the production recipe learn on
the card, and is the semi-supervised ordering right?

The port's counterpart of scripts/learning_quality.py, with the same flags,
defaults, arms, verdict and artifact. Three arms of the production recipe
train at EQUAL labels on the hard synthetic SSL set (low-contrast class
patterns under strong nuisance, written as CIFAR-10 pickles and read back
through ``shotvae_torch.data.datasets.load_dataset``): WRN-28-2, batch
768 + 768, ``--br``, with the 600-epoch SHOT schedule scaled to
``--epochs``:

  * classifier: ``run_classifier`` on the labeled stream alone, its
    500-epoch milestones scaled;
  * M2: ``run_shot_vae(m2=True)``, no posterior regularisation;
  * SHOT: ``run_shot_vae`` with ``--om``.

Expected: SHOT far above the two baselines on test top-1, its accuracy
ramping, and the per-term decomposition showing that a rising scheduled
total is the ew / ucw ramp while the raw reconstruction improves.

The artifact (``--out``) holds ``verdict``, ``summary``, ``timings_s`` and
``curves`` as the JAX script's does, and ``device``: the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, torch's and CUDA's versions, and
``--steps-per-call``. The exit code is the JAX script's: 0 where the
classifier < M2 < SHOT ordering holds and SHOT's KL to the labels fell.

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the plain PyTorch path, for tests at a tiny size. About 10 minutes a seed
on an H100 at ``--steps-per-call 8`` (PERF.md, "Learning through the
port").

    python3 scripts/torch_learning_quality.py [--seed 1] \\
        [--steps-per-call 8] [--out learning_quality_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def make_hard_synthetic(n_train=4096, n_test=2048, num_classes=10, seed=0,
                        signal=14.0, brightness=45.0, contrast=0.35,
                        noise=20.0):
    """Class signal small against the nuisance: few labels underdetermine
    the classes, the unlabeled cluster structure disambiguates.
    ((train images, labels), (test images, labels)), NHWC uint8."""
    rng = np.random.default_rng(seed)
    # smooth class patterns (low spatial frequency, amplitude ~signal)
    freq = rng.normal(size=(num_classes, 4, 4, 3))
    patterns = np.stack([
        np.kron(freq[c], np.ones((8, 8, 1))) for c in range(num_classes)])
    patterns = patterns / np.abs(patterns).max() * signal

    def gen(n, seed2):
        r = np.random.default_rng(seed2)
        labels = r.integers(0, num_classes, n).astype(np.int32)
        x = 128.0 + patterns[labels]
        x = x * (1.0 + r.uniform(-contrast, contrast, (n, 1, 1, 1)))
        x = x + r.uniform(-brightness, brightness, (n, 1, 1, 1))
        x = x + r.normal(0, noise, x.shape)
        return np.clip(x, 0, 255).astype(np.uint8), labels

    return gen(n_train, seed + 1), gen(n_test, seed + 2)


def write_cifar_format(base_path, train, test):
    """Write the sets as cifar-10-batches-py pickles under
    ``<base_path>/dataset/cifar``; returns the train images written (the
    trailing ``len % 5`` are dropped by the 5-batch split)."""
    root = os.path.join(base_path, "dataset", "cifar", "cifar-10-batches-py")
    os.makedirs(root, exist_ok=True)
    (xtr, ytr), (xte, yte) = train, test
    per = len(ytr) // 5
    written = 5 * per

    def dump(path, x, y):
        flat = x.transpose(0, 3, 1, 2).reshape(len(y), -1)
        with open(path, "wb") as f:
            pickle.dump({b"data": flat, b"labels": [int(v) for v in y]}, f)

    for i in range(5):
        sl = slice(i * per, (i + 1) * per)
        dump(os.path.join(root, f"data_batch_{i + 1}"), xtr[sl], ytr[sl])
    dump(os.path.join(root, "test_batch"), xte, yte)
    return written


def scale_milestones(milestones, ref_epochs, epochs):
    return [max(1, round(m * epochs / ref_epochs)) for m in milestones]


def smoothed(xs, k=10):
    xs = np.asarray(xs, np.float64)
    if len(xs) < k:
        return xs
    return np.convolve(xs, np.ones(k) / k, mode="valid")


def arm_summary(history):
    test = [h["test_top1"] for h in history]
    valid = [h["valid_top1"] for h in history]
    sm = smoothed(test)
    q = max(1, len(test) // 4)
    return {
        "best_test_top1": round(max(test), 4),
        "final_test_top1": round(float(np.mean(test[-q:])), 4),
        "best_valid_top1": round(max(valid), 4),
        "ramp_first_q_mean": round(float(np.mean(test[:q])), 4),
        "ramp_last_q_mean": round(float(np.mean(test[-q:])), 4),
        "ramp_monotone": bool(sm[-1] > sm[0]),
    }


def decomposition_verdict(history):
    """Attribute a rising scheduled total to the ew / ucw ramps: the raw
    per-stream terms (recon, the posterior KL to the labels) must improve
    or hold while the schedule's multipliers grow."""
    terms = [h["train_terms"] for h in history]
    scheds = [h["sched"] for h in history]
    q = max(1, len(history) // 4)

    def mean_term(key, sl):
        vals = [t.get(key, 0.0) for t in terms[sl]]
        return float(np.mean(vals)) if vals else 0.0

    first, last = slice(0, q), slice(-q, None)
    out = {
        "loss_first_q": round(mean_term("loss", first), 4),
        "loss_last_q": round(mean_term("loss", last), 4),
        "recon_u_first_q": round(mean_term("recon_u", first), 4),
        "recon_u_last_q": round(mean_term("recon_u", last), 4),
        "kl_inference_first_q": round(mean_term("kl_inference", first), 4),
        "kl_inference_last_q": round(mean_term("kl_inference", last), 4),
        "ew_first": scheds[0]["ew"],
        "ew_last": scheds[-1]["ew"],
        "ucw_first": scheds[0]["ucw"],
        "ucw_last": scheds[-1]["ucw"],
    }
    # the multipliers ramped, the raw reconstruction did not blow up, and
    # the classifier head's KL to the true labels (the learning signal) fell
    out["ew_ramped"] = bool(out["ew_last"] > 10 * out["ew_first"])
    out["recon_u_improved"] = bool(
        out["recon_u_last_q"] < out["recon_u_first_q"])
    out["kl_inference_fell"] = bool(
        out["kl_inference_last_q"] < out["kl_inference_first_q"])
    return out


def device_block(device, steps_per_call: int) -> dict:
    """Where a run ran: the card's name and power limit (nvidia-smi's
    ``name,power.limit``; for the CPU its name and None), torch's and
    CUDA's versions, and the train steps per dispatch."""
    import torch

    from shotvae_torch.device import resolve_device

    dev = resolve_device(device)  # raises where no card is seen
    name, power = str(dev), None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        index = dev.index or 0
        name, power = (s.strip() for s in
                       smi.stdout.strip().splitlines()[index].split(","))
    return {"name": name, "power_limit": power, "torch": torch.__version__,
            "cuda": torch.version.cuda, "steps_per_call": steps_per_call}


def run_arm(arm: str, common: dict, epochs: int, device) -> dict:
    """Train one arm (``classifier``, ``m2`` or ``shot``) on ``device``;
    the loop's result (``history``, ``epoch_times``, ...)."""
    from shotvae_torch.config import ClassifierConfig, ShotVaeConfig
    from shotvae_torch.train.loop import run_classifier, run_shot_vae

    quiet = lambda *a, **k: None  # noqa: E731
    if arm == "classifier":
        ccfg = dict(common,
                    adjust_lr=scale_milestones([300, 350, 400], 500, epochs))
        ccfg.pop("om")
        return run_classifier(ClassifierConfig(**ccfg), log_fn=quiet,
                              device=device)
    if arm == "m2":
        return run_shot_vae(ShotVaeConfig(**dict(common, om=False)),
                            m2=True, log_fn=quiet, device=device)
    if arm == "shot":
        return run_shot_vae(ShotVaeConfig(**common), log_fn=quiet,
                            device=device)
    raise SystemExit(f"unknown arm {arm!r}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--labels-per-class", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=768)
    p.add_argument("--net-name", default="wideresnet-28-2")
    p.add_argument("--n-train", type=int, default=16384)
    p.add_argument("--n-test", type=int, default=2048)
    p.add_argument("--valid-per-class", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="learning_quality_torch.json")
    p.add_argument("--arms", default="classifier,m2,shot")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps-per-call", type=int, default=1)
    args = p.parse_args(argv)

    device = args.device
    block = device_block(device, args.steps_per_call)
    block.setdefault("trunk", "bfloat16")  # the configs' default
    # the data beside the artifact, removed after
    bp = tempfile.mkdtemp(prefix="learning_quality_torch_",
                          dir=os.path.dirname(os.path.abspath(args.out)))
    try:
        train, test = make_hard_synthetic(args.n_train, n_test=args.n_test,
                                          seed=args.seed)
        n_written = write_cifar_format(bp, train, test)

        E = args.epochs
        common = dict(
            base_path=bp, dataset="Cifar10", net_name=args.net_name,
            batch_size=args.batch_size, epochs=E, br=True, yes=True,
            om=True, seed=args.seed, ckpt_every=0,
            reconstruct_freq=10_000_000, print_freq=10_000_000,
            valid_per_class=args.valid_per_class,
            annotated_per_class=args.labels_per_class,
            steps_per_call=args.steps_per_call,
            # the production 600-epoch SHOT schedule scaled to E
            # (akb=200 aew=400 apw=200 adjust_lr=400/500/550; ucw's
            # wmf*epochs ramp scales through cfg.epochs)
            akb=round(200 * E / 600), aew=round(400 * E / 600),
            apw=round(200 * E / 600),
            adjust_lr=scale_milestones([400, 500, 550], 600, E))

        arms, timings = {}, {}
        for arm in args.arms.split(","):
            t0 = time.time()
            res = run_arm(arm, common, E, device)
            arms[arm] = res["history"]
            timings[arm] = round(time.time() - t0, 1)
            print(f"[arm {arm}] done in {timings[arm]}s; best test "
                  f"{max(h['test_top1'] for h in res['history']):.4f}",
                  flush=True)
    finally:
        shutil.rmtree(bp, ignore_errors=True)

    summary = {a: arm_summary(h) for a, h in arms.items()}
    verdict = {
        "equal_labels": args.labels_per_class * 10,
        "unlabeled": n_written,
        "epochs": E,
        "net": args.net_name,
        "batch_size": args.batch_size,
    }
    if {"classifier", "m2", "shot"} <= set(arms):
        c = summary["classifier"]["best_test_top1"]
        m = summary["m2"]["best_test_top1"]
        s = summary["shot"]["best_test_top1"]
        verdict["ordering_ok"] = bool(c < m < s)
        verdict["ssl_gain_m2"] = round(m - c, 4)
        verdict["ssl_gain_shot"] = round(s - c, 4)
    if "shot" in arms:
        verdict["shot_decomposition"] = decomposition_verdict(arms["shot"])
        verdict["shot_ramp_monotone"] = summary["shot"]["ramp_monotone"]

    artifact = {"verdict": verdict, "summary": summary,
                "timings_s": timings, "curves": arms, "device": block}
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"verdict": verdict, "summary": summary,
                      "device": block}, indent=1))
    ok = verdict.get("ordering_ok", False) and \
        verdict.get("shot_decomposition", {}).get("kl_inference_fell", False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
