"""The epoch loops. Port of shotvae_tpu/train/loop.py:151-178, 191-498
(``run_shot_vae``, with ``m2=True`` the M2 baseline) and 501-635
(``run_classifier``, the supervised baseline), the counterparts of the
reference's ``main()/train()/valid()/test()`` (main_shot_vae.py:120-510,
main_M2_vae.py:104-240, main_classifier.py:82-278).

The datasets lie on the device as uint8 (``DeviceDataset``); per step the
host sends one index array and the step gathers, augments, runs the four
forwards, the backward and the update there. Nothing is read back inside
the step loop: the train metrics stay on the device until the epoch ends,
the eval sums until each split ends.

Randomness is keyed by integers, so a resumed run replays exactly what the
uninterrupted run would have drawn:
  * the data order by (seed + 1, epoch) for the labeled stream and
    (seed + 2, epoch) for the unlabeled one (numpy, as in JAX);
  * train step i of an epoch by (seed + 1000, epoch, i), eval batch j by
    (seed + 1000, epoch, 10_000 + j), the train reconstruction grid by
    (seed + 1000, epoch, 99_999): each seeds a fresh host
    ``torch.Generator`` that the step's every random site draws from.

The JAX package's documented deviations hold here too (its README "Parity
and documented deviations"): best is the MAXIMUM validation accuracy,
saved from epoch ``adjust_lr[-1]`` on; the unlabeled stream drops its
ragged tail; the Cifar10 ``ewm`` x5 bump (SHOT-VAE only) comes before the
epoch's save; validation runs on clean images.

The classifier trains on the labeled split alone, ``min(batch_size,
|labeled|)`` images a step and ``ceil(|labeled| / batch)`` steps an epoch,
drawn from one endless stream seeded by ``seed`` (as in JAX); its step i of
an epoch draws its crops, flips and dropout from the same
(seed + 1000, epoch, i) generators. It saves no checkpoint.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from shotvae_torch.config import ClassifierConfig, DatasetSpec, ShotVaeConfig
from shotvae_torch.data.datasets import load_dataset
from shotvae_torch.data.pipeline import (DeviceDataset, epoch_batches,
                                         infinite_batches, num_batches)
from shotvae_torch.data.splits import ssl_split
from shotvae_torch.device import DeviceLike, resolve_device
from shotvae_torch.io.checkpoint import CheckpointManager
from shotvae_torch.io.tb import TBWriter
from shotvae_torch.models.classifier import (WideResNetClassifier,
                                             apply_classifier_init,
                                             build_classifier)
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr, shot_vae_epoch_schedules
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import (make_classifier_eval_step,
                                       make_classifier_train_step,
                                       make_m2_train_step,
                                       make_shot_vae_train_step,
                                       make_vae_eval_step)
from shotvae_torch.utils.meters import AverageMeter, MetricAccumulator

EVAL_KEY = 10_000   # eval batch j draws with step key EVAL_KEY + j
GRID_KEY = 99_999   # the train reconstruction grid's step key


def refuse_unported(cfg: ShotVaeConfig) -> None:
    """Raise for a setting that drives a part the port does not have yet,
    naming its ROADMAP.md item: none is silently ignored."""
    unported = [
        (cfg.bn_per_replica, "--bn-per-replica", 11),
        (cfg.global_mixup, "--global-mixup", 11),
        ((cfg.num_devices or 1) > 1, "--num-devices > 1", 11),
        (cfg.steps_per_call > 1, "--steps-per-call > 1", "13a"),
    ]
    for on, flag, item in unported:
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md queue 1 item {item})")


def _prepare_writer_dir(log_dir: str, *, resume: bool, assume_yes: bool,
                        train_time: int):
    """The reference's interactive removal guard (main_shot_vae.py:215-219),
    with ``--yes`` to skip the question."""
    if resume or not os.path.exists(log_dir):
        return
    if assume_yes:
        shutil.rmtree(log_dir, ignore_errors=True)
        return
    flag = input(
        f"vae_train_time:{train_time} will be removed, input yes to continue:")
    if flag == "yes":
        shutil.rmtree(log_dir, ignore_errors=True)


def _padded_eval_batches(indices: np.ndarray, batch_size: int):
    """Fixed-size eval batches and their 0/1 weight masks (the tail padded
    by wrap-around), as numpy arrays."""
    for idx in epoch_batches(np.random.default_rng(0), indices, batch_size,
                             drop_last=False, shuffle=False):
        real = len(idx)
        weight = np.ones(batch_size, np.float32)
        if real < batch_size:
            idx = np.concatenate([idx, np.resize(idx, batch_size - real)])
            weight[real:] = 0.0
        yield idx, weight


def step_generator(seed: int, epoch: int, i: int) -> torch.Generator:
    """A fresh host generator keyed by (seed + 1000, epoch, i)."""
    state = np.random.SeedSequence([seed + 1000, epoch, i]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def build_model(cfg: ShotVaeConfig, spec: DatasetSpec,
                device: DeviceLike = None) -> VariationalAutoEncoder:
    """The trainer's VAE for ``cfg``, initialised from ``cfg.seed`` (torch's
    default generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return VariationalAutoEncoder(
            cfg.net_name, num_input_channels=spec.input_channels,
            img_size=tuple(cfg.image_size), continuous_latent_dim=cfg.ldc,
            disc_latent_dim=spec.num_classes,
            sample_temperature=cfg.temperature, device=device,
            dtype=cfg.compute_dtype(), drop_rate=cfg.drop_rate,
            small_input=spec.small_input, efficient=cfg.efficient)


def build_classifier_model(cfg: ShotVaeConfig, spec: DatasetSpec,
                           device: DeviceLike = None) -> WideResNetClassifier:
    """The classifier for ``cfg``, initialised from ``cfg.seed``, then its
    convs re-drawn by ``apply_classifier_init`` from ``cfg.seed + 7`` (as
    the JAX loop keys them)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_classifier(cfg.net_name, spec.num_classes,
                                 num_input_channels=spec.input_channels,
                                 drop_rate=cfg.drop_rate, device=device,
                                 dtype=cfg.compute_dtype())
    return apply_classifier_init(model,
                                 torch.Generator().manual_seed(cfg.seed + 7))


def build_state(model, cfg: ShotVaeConfig, steps_per_epoch: int) -> TrainState:
    """SGD with the reference's coupled weight decay and the multistep LR
    of the global step."""
    opt = sgd_torch(model, lr=cfg.lr, momentum=cfg.beta1,
                    weight_decay=cfg.wd)
    return TrainState(model, opt, multistep_lr(cfg.lr, cfg.adjust_lr,
                                               steps_per_epoch))


def _summed(rows) -> dict:
    """{name: 0-d tensor}: the sums over a list of metric dicts of 0-d
    tensors, in float64, on their device (no host read)."""
    keys = list(rows[0])
    table = torch.stack([torch.stack([r[k] for k in keys]) for r in rows])
    return dict(zip(keys, table.to(torch.float64).sum(0).unbind()))


def _host_images(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _datasets(cfg: ShotVaeConfig, spec: DatasetSpec):
    """(train set, test set, SSL split) of ``cfg``, synthetic where asked."""
    train_data, _ = load_dataset(spec.name, cfg.base_path, train=True,
                                 synthetic_fallback=cfg.synthetic_data,
                                 synthetic_size=cfg.synthetic_size)
    test_data, _ = load_dataset(spec.name, cfg.base_path, train=False,
                                synthetic_fallback=cfg.synthetic_data,
                                synthetic_size=max(cfg.synthetic_size // 4,
                                                   256))
    split = ssl_split(train_data.labels, spec.valid_per_class,
                      spec.annotated_per_class, spec.num_classes,
                      seed=cfg.seed)
    return train_data, test_data, split


def run_shot_vae(cfg: ShotVaeConfig, *, m2: bool = False,
                 max_epochs: Optional[int] = None, log_fn=print,
                 device: DeviceLike = None) -> dict:
    """Train the SHOT-VAE (with ``m2``, the M2 baseline: its step, its
    ``cmi`` and no ``ewm`` bump, under ``<dataset>-M2-VAE``) on ``device``
    (None: ``cuda``; the CPU only where the caller passes
    ``device="cpu"``). Returns ``{"best_valid_acc", "history", "state",
    "epoch_times"}``: ``history`` has one entry per epoch with the JAX
    loop's keys, ``epoch_times`` each epoch's ``train_s`` (up to the train
    metrics' read) and ``eval_s`` (the grid, valid and test)."""
    dev = resolve_device(device)
    refuse_unported(cfg)
    tag = "M2-VAE" if m2 else "SHOT-VAE"
    spec = cfg.apply_dataset_overrides(m2=m2)
    train_data, test_data, split = _datasets(cfg, spec)
    if len(split.labeled) == 0 or len(split.unlabeled) < cfg.batch_size:
        raise ValueError(
            f"SSL split too small for training: labeled={len(split.labeled)}, "
            f"unlabeled={len(split.unlabeled)}, batch={cfg.batch_size} "
            f"(dataset {len(train_data.labels)} samples, "
            f"valid_per_class={spec.valid_per_class})")
    train_ds = DeviceDataset(train_data, device=dev)
    test_ds = DeviceDataset(test_data, device=dev)

    model = build_model(cfg, spec, dev)
    steps_per_epoch = num_batches(len(split.unlabeled), cfg.batch_size)
    state = build_state(model, cfg, steps_per_epoch)

    ckpt = CheckpointManager(cfg.base_path, spec.name, cfg.train_time,
                             tag=tag)
    start_epoch = cfg.start_epoch
    if cfg.resume:
        state, start_epoch, stored_cfg = ckpt.restore(state, path=cfg.resume)
        # the reference restores its args wholesale (main_shot_vae.py:202-213)
        for k, v in (stored_cfg or {}).items():
            if hasattr(cfg, k) and k not in ("resume", "start_epoch"):
                setattr(cfg, k, v)
        log_fn(f"=> loaded checkpoint '{cfg.resume}' (epoch {start_epoch})")

    log_dir = os.path.join(cfg.base_path, f"{spec.name}-{tag}", "runs",
                           f"train_time:{cfg.train_time}")
    _prepare_writer_dir(log_dir, resume=bool(cfg.resume), assume_yes=cfg.yes,
                        train_time=cfg.train_time)
    writer = TBWriter(log_dir)

    if m2:
        step = make_m2_train_step(
            model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
            x_sigma=cfg.x_sigma)
    else:
        step = make_shot_vae_train_step(
            model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
            x_sigma=cfg.x_sigma, epsilon=cfg.epsilon, optimal_match=cfg.om)
    evaluate = make_vae_eval_step(model, num_classes=spec.num_classes,
                                  bce=cfg.br, x_sigma=cfg.x_sigma)
    batch = cfg.batch_size
    best_valid_acc = -1.0
    history, epoch_times = [], []
    profiler = None
    total_epochs = max_epochs if max_epochs is not None else cfg.epochs
    for epoch in range(start_epoch, total_epochs):
        if cfg.profile_dir and epoch == start_epoch + 1:
            # the second epoch's train steps (the first one compiles)
            profiler = _start_profile(dev)
        labeled_iter = infinite_batches(
            np.random.default_rng([cfg.seed + 1, epoch]), split.labeled,
            batch)
        rng_u = np.random.default_rng([cfg.seed + 2, epoch])
        epoch_t0 = time.time()
        sched = shot_vae_epoch_schedules(epoch, cfg)
        batch_time = AverageMeter()
        data_time = AverageMeter()
        step_metrics = []
        end = time.time()
        for i, idx_u in enumerate(epoch_batches(rng_u, split.unlabeled,
                                                batch)):
            idx_l = next(labeled_iter)
            data_time.update(time.time() - end)
            images, labels = train_ds.gather(np.concatenate([idx_l, idx_u]))
            step_metrics.append(step(
                state, images[:batch], labels[:batch], images[batch:],
                labels[batch:], sched, step_generator(cfg.seed, epoch, i)))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % cfg.print_freq == 0:
                # host-side times: the step returns before the card is done
                log_fn(f"Epoch: [{epoch}][{i + 1}/{steps_per_epoch}]\t"
                       f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})"
                       f"\tData {data_time.val:.3f} ({data_time.avg:.3f})")
        if profiler is not None:
            _stop_profile(profiler, cfg.profile_dir, epoch)
            profiler = None
        train_sums = MetricAccumulator()
        train_sums.update(_summed(step_metrics))  # the epoch's one read
        train_terms = {k: v / len(step_metrics)
                       for k, v in train_sums.totals.items()}
        train_s = time.time() - epoch_t0
        writer.scalar("Train/KL_Inference",
                      train_terms.get("kl_inference", 0.0), epoch + 1)
        log_images = epoch % cfg.reconstruct_freq == 0
        if log_images:
            # an eval-mode forward of 4 images of the last unlabeled batch
            img4, lab4 = train_ds.gather(idx_u[:4])
            _, recon4 = evaluate(img4, lab4, torch.ones(4, device=dev),
                                 generator=step_generator(cfg.seed, epoch,
                                                          GRID_KEY))
            writer.image_grid("Train/Raw_Image", _host_images(img4) / 255.0,
                              epoch + 1)
            writer.image_grid("Train/Reconstruct_Image", _host_images(recon4),
                              epoch + 1)

        results = {}
        for split_name, indices, ds in (
                ("Valid", split.valid, train_ds),
                ("Test", np.arange(len(test_data.labels)), test_ds)):
            batch_metrics, first = [], None
            for j, (idx, weight) in enumerate(_padded_eval_batches(indices,
                                                                   batch)):
                img, lab = ds.gather(idx)
                metrics, recon = evaluate(
                    img, lab, torch.from_numpy(weight).to(dev,
                                                          non_blocking=True),
                    generator=step_generator(cfg.seed, epoch, EVAL_KEY + j))
                batch_metrics.append(metrics)
                if first is None:
                    first = (img[:4], recon[:4])
            acc = MetricAccumulator()
            acc.update(_summed(batch_metrics))  # the split's one read
            avg = acc.averages()
            results[split_name] = avg
            writer.scalar(f"{split_name}/KL(q(z|X)||p(z))",
                          avg["cont_kl_avg"], epoch + 1)
            writer.scalar(f"{split_name}/KL(q(y|X)||p(y))",
                          avg["disc_kl_avg"], epoch + 1)
            writer.scalar(f"{split_name}/log(p(X|z,y))", avg["mse_avg"],
                          epoch + 1)
            writer.scalar(f"{split_name}/ELBO", avg["elbo_avg"], epoch + 1)
            writer.scalar(f"{split_name}/top1 accuracy", avg["top1_rate"],
                          epoch + 1)
            if spec.name == "Cifar100":
                writer.scalar(f"{split_name}/top 5 accuracy",
                              avg["top5_rate"], epoch + 1)
            if log_images and first is not None:
                writer.image_grid(f"{split_name}/Raw_Image",
                                  _host_images(first[0]) / 255.0, epoch + 1)
                writer.image_grid(f"{split_name}/Reconstruct_Image",
                                  _host_images(first[1]), epoch + 1)

        valid_acc = results["Valid"]["top1_rate"]
        test_acc = results["Test"]["top1_rate"]
        log_fn(f"Epoch {epoch}: valid top1 {valid_acc:.4f}, "
               f"test top1 {test_acc:.4f}")
        history.append({"epoch": epoch, "valid_top1": valid_acc,
                        "test_top1": test_acc,
                        "train_loss": train_terms.get("loss", 0.0),
                        "train_terms": train_terms,
                        "sched": {k: float(v) for k, v in sched.items()},
                        "seconds": time.time() - epoch_t0})
        epoch_times.append({"train_s": train_s,
                            "eval_s": history[-1]["seconds"] - train_s})

        # the SHOT-VAE's Cifar10 ewm x5 bump at the first milestone, BEFORE
        # the save, so that a resume from the next epoch trains with the
        # bumped value; M2 has none (main_M2_vae.py)
        if not m2 and spec.name == "Cifar10" and cfg.annotated_ratio >= 0.05 \
                and epoch == cfg.adjust_lr[0]:
            cfg.ewm = cfg.ewm * 5
        # ckpt_every <= 0 disables every save
        if cfg.ckpt_every > 0 and ((epoch + 1) % cfg.ckpt_every == 0
                                   or epoch == total_epochs - 1):
            ckpt.save(state, epoch=epoch + 1, config=cfg.asdict())
        if valid_acc > best_valid_acc:
            best_valid_acc = valid_acc
            if cfg.ckpt_every > 0 and epoch >= cfg.adjust_lr[-1]:
                ckpt.save(state, epoch=epoch + 1, config=cfg.asdict(),
                          best=True)
        writer.flush()

    writer.close()
    ckpt.wait_until_finished()  # the last write lands before the return
    return {"best_valid_acc": best_valid_acc, "history": history,
            "state": state, "epoch_times": epoch_times}


def _split_results(evaluate, ds, indices, batch: int, dev) -> dict:
    """``evaluate(img, lab, weight)`` over ``indices`` of ``ds`` in padded
    batches, read once: the accumulated averages."""
    batch_metrics = []
    for idx, weight in _padded_eval_batches(indices, batch):
        img, lab = ds.gather(idx)
        batch_metrics.append(evaluate(
            img, lab, torch.from_numpy(weight).to(dev, non_blocking=True)))
    acc = MetricAccumulator()
    acc.update(_summed(batch_metrics))  # the split's one read
    return acc.averages()


def run_classifier(cfg: ClassifierConfig, *, max_epochs: Optional[int] = None,
                   log_fn=print, device: DeviceLike = None) -> dict:
    """Train the supervised classifier on the labeled split on ``device``
    (None: ``cuda``; the CPU only where the caller passes
    ``device="cpu"``), logging under ``<dataset>-SSL-Classifier``. Returns
    ``{"history", "train_losses", "state", "epoch_times"}``: ``history``
    and ``train_losses`` as the JAX loop's, ``epoch_times`` each epoch's
    ``train_s`` (up to the train losses' read) and ``eval_s``."""
    dev = resolve_device(device)
    refuse_unported(cfg)
    spec = cfg.apply_dataset_overrides()
    train_data, test_data, split = _datasets(cfg, spec)
    if len(split.labeled) == 0:
        raise ValueError(
            f"SSL split has no labeled samples (dataset "
            f"{len(train_data.labels)}, valid_per_class="
            f"{spec.valid_per_class})")
    train_ds = DeviceDataset(train_data, device=dev)
    test_ds = DeviceDataset(test_data, device=dev)

    model = build_classifier_model(cfg, spec, dev)
    batch = min(cfg.batch_size, len(split.labeled))
    steps_per_epoch = max(1, num_batches(len(split.labeled), batch,
                                         drop_last=False))
    state = build_state(model, cfg, steps_per_epoch)

    log_dir = os.path.join(cfg.base_path, f"{spec.name}-SSL-Classifier",
                           "runs", f"train_time:{cfg.train_time}")
    _prepare_writer_dir(log_dir, resume=False, assume_yes=cfg.yes,
                        train_time=cfg.train_time)
    writer = TBWriter(log_dir)

    step = make_classifier_train_step(model, state.optimizer)
    evaluate = make_classifier_eval_step(model, num_classes=spec.num_classes)
    labeled_iter = infinite_batches(np.random.default_rng(cfg.seed),
                                    split.labeled, batch)
    history, train_losses, epoch_times = [], [], []
    total_epochs = max_epochs if max_epochs is not None else cfg.epochs
    for epoch in range(total_epochs):
        epoch_t0 = time.time()
        step_losses = []
        for i in range(steps_per_epoch):
            img, lab = train_ds.gather(next(labeled_iter))
            step_losses.append(step(state, img, lab,
                                    step_generator(cfg.seed, epoch, i))
                               ["cls_loss"])
        losses = AverageMeter()
        # the epoch's one read
        for v in torch.stack(step_losses).to(torch.float64).tolist():
            losses.update(v, batch)
        train_s = time.time() - epoch_t0
        writer.scalar("Train/cls_loss", losses.avg, epoch + 1)
        train_losses.append(losses.avg)

        out = {}
        for name, indices, ds in (("Valid", split.valid, train_ds),
                                  ("Test", np.arange(len(test_data.labels)),
                                   test_ds)):
            avg = _split_results(evaluate, ds, indices, cfg.batch_size, dev)
            out[name] = avg
            writer.scalar(f"{name}/cls_loss", avg["cls_loss_avg"], epoch + 1)
            writer.scalar(f"{name}/top 1 accuracy", avg["top1_rate"],
                          epoch + 1)
            if spec.name == "Cifar100":
                writer.scalar(f"{name}/top 5 accuracy", avg["top5_rate"],
                              epoch + 1)
        log_fn(f"Epoch {epoch}: valid {out['Valid']['top1_rate']:.4f} "
               f"test {out['Test']['top1_rate']:.4f}")
        history.append({"epoch": epoch,
                        "valid_top1": out["Valid"]["top1_rate"],
                        "test_top1": out["Test"]["top1_rate"],
                        "train_loss": losses.avg})
        epoch_times.append({"train_s": train_s,
                            "eval_s": time.time() - epoch_t0 - train_s})
        writer.flush()
    writer.close()
    return {"history": history, "train_losses": train_losses,
            "state": state, "epoch_times": epoch_times}


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, epoch: int) -> None:
    """Stop ``prof`` once the card has run what it traced, and write its
    Chrome trace into ``profile_dir``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"epoch{epoch}.pt.trace.json"))
