#!/usr/bin/env python3
"""Smooth-ELBO learning quality through the port: do both one-stage
recipes learn on the card?

The port's counterpart of scripts/smooth_elbo_learning.py, with the same
flags, defaults, verdict and artifact. It trains the capacity-annealed
smooth-ELBO VAEs (``shotvae_torch.train.loop.run_smooth_elbo``: MNIST's,
and SVHN's with the ReduceLROnPlateau scale) through the real loaders on
the hard synthetic set of scripts/torch_learning_quality.py, written in
the raw formats:

  * MNIST arm: channel 0 of the hard set as 32x32 idx-ubyte files;
  * SVHN arm: the RGB hard set as train_32x32.mat / test_32x32.mat with
    the label 0 -> 10 convention the parser maps back.

The capacity schedules anneal over a fixed iteration count in the
reference (25,000 MNIST / 50,000 SVHN steps); here they are scaled to the
run's step count, so that the anneal takes the same fraction of training.

Per arm the verdict reads: test top-1 above chance, the unlabeled
reconstruction's first and last quarters, the unlabeled continuous KL
against the annealed capacity at the end (``kl_cont / C``), the discrete
KL against its maximum log 10, no NaN, and for SVHN the plateau's trace.
The artifact is written after each arm, and holds ``device`` (the card's
name and power limit, torch's and CUDA's versions) beside the JAX
artifact's keys.

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the plain PyTorch path, for tests at a tiny size. A few minutes on an H100
at the defaults (PERF.md, "Learning through the port").

    python3 scripts/torch_smooth_elbo_learning.py [--epochs 80] \\
        [--n-train 8192] [--out smooth_elbo_learning_torch.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import struct
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _learning_quality():
    """scripts/torch_learning_quality.py, loaded from beside this file."""
    spec = importlib.util.spec_from_file_location(
        "torch_learning_quality",
        os.path.join(HERE, "torch_learning_quality.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_mnist_idx(root, train, test):
    """Write (images NHWC uint8, labels) pairs as the 4 idx-ubyte files."""
    os.makedirs(root, exist_ok=True)
    for prefix, (x, y) in (("train", train), ("t10k", test)):
        assert x.ndim == 4 and x.shape[-1] == 1
        n, rows, cols, _ = x.shape
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, rows, cols))
            f.write(np.ascontiguousarray(x[..., 0]).tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(np.asarray(y, np.uint8).tobytes())


def write_svhn_mat(root, train, test):
    """Write .mat files in the real SVHN layout (X HWCN, y with 0 -> 10)."""
    import scipy.io

    os.makedirs(root, exist_ok=True)
    for name, (x, y) in (("train_32x32.mat", train), ("test_32x32.mat", test)):
        # read back by shotvae_torch/data/datasets.py:load_svhn
        y10 = np.where(np.asarray(y) == 0, 10, np.asarray(y))
        scipy.io.savemat(os.path.join(root, name),
                         {"X": np.ascontiguousarray(x.transpose(1, 2, 3, 0)),
                          "y": y10.reshape(-1, 1).astype(np.uint8)})


def capacity_at(step, cap_min, cap_max, num_iters, theoretical_max=None):
    c = (cap_max - cap_min) * step / float(num_iters) + cap_min
    c = min(c, cap_max)
    if theoretical_max is not None:
        c = min(c, theoretical_max)
    return c


def smoothed(xs, k=10):
    xs = np.asarray(xs, np.float64)
    if len(xs) < k:
        return xs
    return np.convolve(xs, np.ones(k) / k, mode="valid")


def arm_verdict(history, *, cont_capacity, disc_capacity, steps_per_epoch,
                num_classes=10):
    acc = np.array([h["test_acc"] for h in history])
    recon_u = np.array([h["train_terms"]["u_recon"] for h in history])
    kl_cont = np.array([h["train_terms"]["kl_cont"] for h in history])
    kl_disc = np.array([h["train_terms"]["kl_disc"] for h in history])
    loss = np.array([h["mean_loss"] for h in history])
    q = max(1, len(history) // 4)
    sm = smoothed(acc)
    final_step = len(history) * steps_per_epoch
    c_cont_last = capacity_at(final_step, *cont_capacity[:3])
    c_disc_last = capacity_at(final_step, *disc_capacity[:3],
                              theoretical_max=math.log(num_classes))
    out = {
        "best_test_top1": float(acc.max()),
        "acc_first_q": float(acc[:q].mean()),
        "acc_last_q": float(acc[-q:].mean()),
        "ramp_monotone": bool(sm[-1] > sm[0]),
        "above_chance": bool(acc[-q:].mean() > 2.0 / num_classes),
        "recon_u_first_q": float(recon_u[:q].mean()),
        "recon_u_last_q": float(recon_u[-q:].mean()),
        "recon_u_improved": bool(recon_u[-q:].mean() < recon_u[:q].mean()),
        "kl_cont_first": float(kl_cont[0]),
        "kl_cont_last": float(kl_cont[-1]),
        "capacity_cont_last": float(c_cont_last),
        "kl_cont_over_capacity_last": float(kl_cont[-1] / max(c_cont_last,
                                                              1e-9)),
        "kl_cont_tracks_capacity": bool(
            0.5 <= kl_cont[-1] / max(c_cont_last, 1e-9) <= 1.5),
        "kl_disc_last": float(kl_disc[-1]),
        "kl_disc_theoretical_max": float(math.log(num_classes)),
        "kl_disc_saturated": bool(
            kl_disc[-1] > 0.8 * math.log(num_classes)),
        "nan_free": bool(np.isfinite(loss).all()
                         and np.isfinite(recon_u).all()),
    }
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--n-train", type=int, default=8192)
    p.add_argument("--n-test", type=int, default=2048)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--arms", default="mnist,svhn")
    p.add_argument("--out", default="smooth_elbo_learning_torch.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from shotvae_torch.config import SmoothElboConfig, svhn_smooth_defaults
    from shotvae_torch.train.loop import run_smooth_elbo

    lq = _learning_quality()
    # the smooth trainers dispatch one step at a time
    result = {"config": {"epochs": args.epochs, "n_train": args.n_train,
                         "n_test": args.n_test, "seed": args.seed},
              "arms": {}, "device": lq.device_block(args.device, 1)}
    (xtr, ytr), (xte, yte) = lq.make_hard_synthetic(
        n_train=args.n_train, n_test=args.n_test, seed=args.seed)

    def run_arm(dataset, cfg, data_writer):
        # the data and run folder beside the artifact, removed after
        tmp = tempfile.mkdtemp(prefix=f"smooth_lq_torch_{dataset}_",
                               dir=os.path.dirname(os.path.abspath(args.out)))
        try:
            data_dir = os.path.join(tmp, "data")
            data_writer(data_dir)
            cfg.base_path = tmp
            cfg.path_to_data = data_dir
            cfg.seed = args.seed

            # scale the capacity anneal to the same FRACTION of training as
            # the reference run (iters_ref / total_steps_ref)
            ref_train = 60_000 if dataset == "mnist" else 73_257
            ref_steps = cfg.epochs * math.ceil(ref_train
                                               / cfg.unlabeled_batch_size)
            steps_per_epoch = math.ceil(args.n_train
                                        / cfg.unlabeled_batch_size)
            run_steps = args.epochs * steps_per_epoch
            scale = run_steps / ref_steps
            cfg.cont_capacity = (cfg.cont_capacity[0], cfg.cont_capacity[1],
                                 max(1, round(cfg.cont_capacity[2] * scale)),
                                 cfg.cont_capacity[3])
            cfg.disc_capacity = (cfg.disc_capacity[0], cfg.disc_capacity[1],
                                 max(1, round(cfg.disc_capacity[2] * scale)),
                                 cfg.disc_capacity[3])

            t0 = time.time()
            out = run_smooth_elbo(cfg, dataset, max_epochs=args.epochs,
                                  log_fn=lambda *a: None, device=args.device)
            wall = time.time() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        hist = out["history"]
        verdict = arm_verdict(hist, cont_capacity=cfg.cont_capacity,
                              disc_capacity=cfg.disc_capacity,
                              steps_per_epoch=steps_per_epoch)
        verdict["wall_s"] = round(wall, 1)
        verdict["cont_capacity"] = list(cfg.cont_capacity)
        verdict["disc_capacity"] = list(cfg.disc_capacity)
        if cfg.use_plateau_scheduler:
            lrs = [h["lr_scale"] for h in hist]
            verdict["lr_scale_final"] = float(lrs[-1])
            verdict["lr_decays"] = int(
                sum(1 for a, b in zip(lrs, lrs[1:]) if b < a))
        curves = [{k: (v if not isinstance(v, dict) else
                       {kk: float(vv) for kk, vv in v.items()})
                   for k, v in h.items()} for h in hist]
        return {"verdict": verdict, "curves": curves}

    arms = args.arms.split(",")
    if "mnist" in arms:
        gray_tr = xtr[..., :1]  # channel 0: the full pattern amplitude
        gray_te = xte[..., :1]
        cfg = SmoothElboConfig()
        result["arms"]["mnist"] = run_arm(
            "mnist", cfg,
            lambda d: write_mnist_idx(d, (gray_tr, ytr), (gray_te, yte)))
        with open(args.out, "w") as f:       # the artifact after each arm
            json.dump(result, f, indent=1)
        print("mnist:", json.dumps(result["arms"]["mnist"]["verdict"]),
              flush=True)

    if "svhn" in arms:
        cfg = svhn_smooth_defaults()
        result["arms"]["svhn"] = run_arm(
            "svhn", cfg,
            lambda d: write_svhn_mat(d, (xtr, ytr), (xte, yte)))
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print("svhn:", json.dumps(result["arms"]["svhn"]["verdict"]),
              flush=True)

    ok = all(a["verdict"]["above_chance"] and a["verdict"]["nan_free"]
             and a["verdict"]["recon_u_improved"]
             for a in result["arms"].values())
    result["ok"] = bool(ok)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": ok, "out": args.out, "device": result["device"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
