"""The epoch loops. Port of shotvae_tpu/train/loop.py:151-178, 191-498
(``run_shot_vae``, with ``m2=True`` the M2 baseline), 501-635
(``run_classifier``, the supervised baseline) and 638-818
(``run_smooth_elbo``, the one-stage MNIST and SVHN trainers, with
``ReduceLROnPlateau``), the counterparts of the reference's
``main()/train()/valid()/test()`` (main_shot_vae.py:120-510,
main_M2_vae.py:104-240, main_classifier.py:82-278,
main_smooth_ELBO_mnist.py:36-225, main_smooth_ELBO_svhn.py).

The datasets lie on the device as uint8 (``DeviceDataset``); per step the
host sends one index array and the step gathers, augments, runs the four
forwards, the backward and the update there. Nothing is read back inside
the step loop: the train metrics stay on the device until the epoch ends,
the eval sums until each split ends. With ``steps_per_call`` N above 1 the
SHOT-VAE, M2 and classifier loops dispatch chunks of N steps
(``train.chunk``), in one process or over a process group in both BN
modes: on the card one CUDA graph replay per chunk, the same steps, keys
and batches as per-step dispatch, as the JAX loop's chunked branch; the
eval steps stay one dispatch per batch.

Randomness is keyed by integers, so a resumed run replays exactly what the
uninterrupted run would have drawn:
  * the data order by (seed + 1, epoch) for the labeled stream and
    (seed + 2, epoch) for the unlabeled one (numpy, as in JAX);
  * train step i of an epoch by (seed + 1000, epoch, i), eval batch j by
    (seed + 1000, epoch, 10_000 + j), the train reconstruction grid by
    (seed + 1000, epoch, 99_999): each seeds a fresh host
    ``torch.Generator`` that the step's every random site draws from;
    over several ranks (``shotvae_torch.parallel``) that generator draws
    only what every rank shares (mixup's weights and partners), and each
    rank draws its rows' crops, flips, latent noise and dropout from
    (seed + 1000, epoch, i, rank + 1).

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

The smooth-ELBO trainer takes the JAX loop's streams as they are: the
unlabeled order from one numpy generator seeded ``seed + 1`` and the
labeled batches from one endless stream seeded ``seed + 2``, both running
on across epochs (so it does not resume), and its step i of an epoch draws
from the (seed + 1000, epoch, i) generator. It writes its log file, no
TensorBoard run, and one checkpoint at the end.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from shotvae_torch.config import (ClassifierConfig, DatasetSpec,
                                  ShotVaeConfig, SmoothElboConfig)
from shotvae_torch.data.datasets import (ArrayDataset, load_dataset,
                                         load_mnist, load_svhn,
                                         synthetic_dataset)
from shotvae_torch.data.pipeline import (DeviceDataset, epoch_batches,
                                         infinite_batches, num_batches,
                                         resize_batch)
from shotvae_torch.data.splits import labeled_subset_per_class, ssl_split
from shotvae_torch.device import DeviceLike, exact_f32, resolve_device
from shotvae_torch.io.checkpoint import CheckpointManager
from shotvae_torch.io.tb import TBWriter
from shotvae_torch.models.classifier import (WideResNetClassifier,
                                             apply_classifier_init,
                                             build_classifier)
from shotvae_torch.models.smooth_vae import (SmoothVAE, mnist_vae_config,
                                             svhn_vae_config)
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr, shot_vae_epoch_schedules
from shotvae_torch.parallel.mesh import (DataParallel, rank_generator,
                                         refuse_ranks, setup)
from shotvae_torch.train.chunk import ChunkRunner
from shotvae_torch.train.state import TrainState, adam_torch, sgd_torch
from shotvae_torch.train.steps import (make_classifier_eval_step,
                                       make_classifier_train_step,
                                       make_m2_train_step,
                                       make_shot_vae_train_step,
                                       make_smooth_elbo_eval_step,
                                       make_smooth_elbo_train_step,
                                       make_vae_eval_step)
from shotvae_torch.utils.meters import AverageMeter, MetricAccumulator

EVAL_KEY = 10_000   # eval batch j draws with step key EVAL_KEY + j
GRID_KEY = 99_999   # the train reconstruction grid's step key


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


def step_generators(seed: int, epoch: int, i: int, dp: DataParallel):
    """(the rank's generator, the shared one) of train step (or eval key)
    ``i``: on one process with no group, ``step_generator`` alone (None
    shared); over a group, the rank's own ``rank_generator`` for per-row
    draws and ``step_generator``, which every rank seeds alike, for the
    draws over the global batch."""
    if dp.group is None:
        return step_generator(seed, epoch, i), None
    return (rank_generator(seed, epoch, i, dp.rank),
            step_generator(seed, epoch, i))


def _quiet(*args, **kwargs) -> None:
    """The log of a data-parallel run's ranks but the first."""


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


def _summed(rows, keys=None) -> dict:
    """{name: 0-d tensor}: the sums over a list of metric dicts of 0-d
    tensors, or over the rows of (n, len(keys)) tables of them (a chunk
    runner's), in float64, on their device (no host read)."""
    if keys is None:
        keys = list(rows[0])
        table = torch.stack([torch.stack([r[k] for k in keys]) for r in rows])
    else:
        table = torch.cat(rows)
    return dict(zip(keys, table.to(torch.float64).sum(0).unbind()))


def _chunk_runner(cfg, dev, step_by_index, width: int, dp: DataParallel):
    """The chunk runner of ``cfg.steps_per_call`` above 1 over ``dp``'s
    ranks, each step on ``width`` indices of this rank's rows, else
    None."""
    if cfg.steps_per_call <= 1:
        return None
    return ChunkRunner(step_by_index, dev, steps=cfg.steps_per_call,
                       width=width, dp=dp)


def _dispatch(runner, step_by_index, state, rows: np.ndarray, sched,
              seed: int, epoch: int, c0: int, dp: DataParallel,
              streams: int):
    """Train steps [c0, c0 + n) of ``epoch`` on the (n, width) index
    ``rows``, each row ``streams`` blocks of the global batch's indices,
    each step on this rank's share of each block, step i drawing from
    per-step dispatch's host generators (``step_generators``; JAX's
    ``_chunk_keys``). With a chunk runner (``steps_per_call`` above 1):
    one chunk; returns its (n, len(runner.keys)) metrics. Else the one
    step itself; returns its metric dict."""
    local = np.stack([np.concatenate([dp.shard(b)
                                      for b in np.split(row, streams)])
                      for row in rows])
    keys = [step_generators(seed, epoch, i, dp)
            for i in range(c0, c0 + len(rows))]
    if runner is not None:
        return runner.run(state, local, keys)
    ((row,), ((gen, shared),)) = local, keys
    return step_by_index(state, row, sched, gen, shared=shared)


def shot_vae_chunks(seed: int, epoch: int, labeled: np.ndarray,
                    unlabeled: np.ndarray, batch: int, steps: int):
    """The index chunks of one SHOT-VAE or M2 epoch: (first step, (n, 2 *
    batch) rows of labeled | unlabeled indices), n = ``steps`` but in the
    last chunk, from the streams of per-step dispatch (the JAX loop's
    chunked branch, shotvae_tpu/train/loop.py:341-349)."""
    labeled_iter = infinite_batches(
        np.random.default_rng([seed + 1, epoch]), labeled, batch)
    u_batches = list(epoch_batches(np.random.default_rng([seed + 2, epoch]),
                                   unlabeled, batch))
    l_batches = [next(labeled_iter) for _ in u_batches]
    for c0 in range(0, len(u_batches), steps):
        yield c0, np.concatenate([np.stack(l_batches[c0:c0 + steps]),
                                  np.stack(u_batches[c0:c0 + steps])],
                                 axis=1)


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


@exact_f32()
def run_shot_vae(cfg: ShotVaeConfig, *, m2: bool = False,
                 max_epochs: Optional[int] = None, log_fn=print,
                 device: DeviceLike = None) -> dict:
    """Train the SHOT-VAE (with ``m2``, the M2 baseline: its step, its
    ``cmi`` and no ``ewm`` bump, under ``<dataset>-M2-VAE``) on ``device``
    (None: ``cuda``; the CPU only where the caller passes
    ``device="cpu"``). Returns ``{"best_valid_acc", "history", "state",
    "epoch_times"}``: ``history`` has one entry per epoch with the JAX
    loop's keys, ``epoch_times`` each epoch's ``train_s`` (up to the train
    metrics' read) and ``eval_s`` (the grid, valid and test).

    Data parallel over the ranks of a process group (``parallel.setup``:
    torchrun's, or one the caller made): each rank trains on its rows of
    every global batch of ``batch_size`` (sync-BN, or ``bn_per_replica``
    with ``global_mixup``) and evaluates its rows of each eval batch, the
    sums added over the ranks; every rank restores ``resume``, and only the
    first writes checkpoints, TensorBoard events and the log."""
    dev = resolve_device(device)
    dp = setup(cfg, dev)
    if cfg.batch_size % dp.world_size:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by the number of "
            f"ranks {dp.world_size} (use --num-devices or adjust -b)")
    log_fn = log_fn if dp.is_main else _quiet
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
    if dp.is_main:
        _prepare_writer_dir(log_dir, resume=bool(cfg.resume),
                            assume_yes=cfg.yes, train_time=cfg.train_time)
    dp.barrier()
    writer = TBWriter(log_dir, enabled=dp.is_main)

    ranks = dict(dp=dp, bn_per_replica=cfg.bn_per_replica)
    if m2:
        step = make_m2_train_step(
            model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
            x_sigma=cfg.x_sigma, **ranks)
    else:
        step = make_shot_vae_train_step(
            model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
            x_sigma=cfg.x_sigma, epsilon=cfg.epsilon, optimal_match=cfg.om,
            global_mixup=cfg.global_mixup, **ranks)
    evaluate = make_vae_eval_step(model, num_classes=spec.num_classes,
                                  bce=cfg.br, x_sigma=cfg.x_sigma)
    batch = cfg.batch_size
    local = batch // dp.world_size

    def step_by_index(state, idx, sched, gen, inject=None, shared=None):
        images, labels = train_ds.gather(idx)
        return step(state, images[:local], labels[:local], images[local:],
                    labels[local:], sched, gen, inject=inject,
                    shared_generator=shared)

    runner = _chunk_runner(cfg, dev, step_by_index, 2 * local, dp)
    best_valid_acc = -1.0
    history, epoch_times = [], []
    profiler = None
    total_epochs = max_epochs if max_epochs is not None else cfg.epochs
    for epoch in range(start_epoch, total_epochs):
        if cfg.profile_dir and epoch == start_epoch + 1 and dp.is_main:
            # the second epoch's train steps (the first one compiles)
            profiler = _start_profile(dev)
        epoch_t0 = time.time()
        sched = shot_vae_epoch_schedules(epoch, cfg)
        batch_time = AverageMeter()
        data_time = AverageMeter()
        step_metrics, n_steps = [], 0
        if runner is not None:
            runner.set_sched(sched)
        steps = cfg.steps_per_call
        chunks = list(shot_vae_chunks(cfg.seed, epoch, split.labeled,
                                      split.unlabeled, batch, steps))
        end = time.time()  # the epoch's index prep is not a step's
        for c0, idx in chunks:
            n = len(idx)
            data_time.update((time.time() - end) / n, n)
            step_metrics.append(_dispatch(runner, step_by_index, state, idx,
                                          sched, cfg.seed, epoch, c0, dp, 2))
            n_steps += n
            batch_time.update((time.time() - end) / n, n)
            end = time.time()
            if (c0 // steps) % cfg.print_freq == 0:
                # host-side times: the steps return before the card is done
                log_fn(f"Epoch: [{epoch}][{c0 + n}/{steps_per_epoch}]\t"
                       f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})"
                       f"\tData {data_time.val:.3f} ({data_time.avg:.3f})")
        idx_u = chunks[-1][1][-1, batch:]  # the reconstruction grid
        if profiler is not None:
            _stop_profile(profiler, cfg.profile_dir, epoch)
            profiler = None
        train_sums = MetricAccumulator()
        # the epoch's one read
        train_sums.update(_summed(step_metrics,
                                  runner and runner.keys))
        train_terms = {k: v / n_steps for k, v in train_sums.totals.items()}
        train_s = time.time() - epoch_t0
        writer.scalar("Train/KL_Inference",
                      train_terms.get("kl_inference", 0.0), epoch + 1)
        log_images = epoch % cfg.reconstruct_freq == 0 and dp.is_main
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
                img, lab = ds.gather(dp.shard(idx))
                metrics, recon = evaluate(
                    img, lab, torch.from_numpy(dp.shard(weight)).to(
                        dev, non_blocking=True),
                    generator=step_generators(cfg.seed, epoch, EVAL_KEY + j,
                                              dp)[0])
                batch_metrics.append(metrics)
                if first is None:
                    first = (img[:4], recon[:4])
            acc = MetricAccumulator()
            # the split's one read, of the sums over the ranks
            acc.update(dp.sum_metrics(_summed(batch_metrics)))
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
        # ckpt_every <= 0 disables every save; the first rank saves
        saves = cfg.ckpt_every > 0 and dp.is_main
        if saves and ((epoch + 1) % cfg.ckpt_every == 0
                      or epoch == total_epochs - 1):
            ckpt.save(state, epoch=epoch + 1, config=cfg.asdict())
        if valid_acc > best_valid_acc:
            best_valid_acc = valid_acc
            if saves and epoch >= cfg.adjust_lr[-1]:
                ckpt.save(state, epoch=epoch + 1, config=cfg.asdict(),
                          best=True)
        writer.flush()

    writer.close()
    ckpt.wait_until_finished()  # the last write lands before the return
    dp.barrier()  # and before any rank returns
    return {"best_valid_acc": best_valid_acc, "history": history,
            "state": state, "epoch_times": epoch_times}


def _split_results(evaluate, ds, indices, batch: int, dev,
                   dp: Optional[DataParallel] = None) -> dict:
    """``evaluate(img, lab, weight)`` over ``indices`` of ``ds`` in padded
    batches, read once: the accumulated averages; over the ranks of
    ``dp``, each evaluates its rows of every batch and the sums are added
    over them."""
    dp = dp or DataParallel()
    batch_metrics = []
    for idx, weight in _padded_eval_batches(indices, batch):
        img, lab = ds.gather(dp.shard(idx))
        batch_metrics.append(evaluate(
            img, lab, torch.from_numpy(dp.shard(weight)).to(
                dev, non_blocking=True)))
    acc = MetricAccumulator()
    acc.update(dp.sum_metrics(_summed(batch_metrics)))  # the one read
    return acc.averages()


@exact_f32()
def run_classifier(cfg: ClassifierConfig, *, max_epochs: Optional[int] = None,
                   log_fn=print, device: DeviceLike = None) -> dict:
    """Train the supervised classifier on the labeled split on ``device``
    (None: ``cuda``; the CPU only where the caller passes
    ``device="cpu"``), logging under ``<dataset>-SSL-Classifier``. Returns
    ``{"history", "train_losses", "state", "epoch_times"}``: ``history``
    and ``train_losses`` as the JAX loop's, ``epoch_times`` each epoch's
    ``train_s`` (up to the train losses' read) and ``eval_s``. Data
    parallel as ``run_shot_vae``, with the batch, and the eval batch,
    rounded up to a multiple of the number of ranks (the JAX loop's
    ``pad_batch_size``)."""
    dev = resolve_device(device)
    dp = setup(cfg, dev)
    log_fn = log_fn if dp.is_main else _quiet
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
    batch = dp.pad_batch_size(min(cfg.batch_size, len(split.labeled)))
    eval_batch = dp.pad_batch_size(cfg.batch_size)
    steps_per_epoch = max(1, num_batches(len(split.labeled), batch,
                                         drop_last=False))
    state = build_state(model, cfg, steps_per_epoch)

    log_dir = os.path.join(cfg.base_path, f"{spec.name}-SSL-Classifier",
                           "runs", f"train_time:{cfg.train_time}")
    if dp.is_main:
        _prepare_writer_dir(log_dir, resume=False, assume_yes=cfg.yes,
                            train_time=cfg.train_time)
    dp.barrier()
    writer = TBWriter(log_dir, enabled=dp.is_main)

    step = make_classifier_train_step(model, state.optimizer, dp=dp,
                                      bn_per_replica=cfg.bn_per_replica)
    evaluate = make_classifier_eval_step(model, num_classes=spec.num_classes)

    def step_by_index(state, idx, sched, gen, inject=None, shared=None):
        img, lab = train_ds.gather(idx)
        return step(state, img, lab, gen, inject)

    runner = _chunk_runner(cfg, dev, step_by_index,
                           batch // dp.world_size, dp)
    labeled_iter = infinite_batches(np.random.default_rng(cfg.seed),
                                    split.labeled, batch)
    history, train_losses, epoch_times = [], [], []
    total_epochs = max_epochs if max_epochs is not None else cfg.epochs
    for epoch in range(total_epochs):
        epoch_t0 = time.time()
        step_losses = []
        idxs = [next(labeled_iter) for _ in range(steps_per_epoch)]
        for c0 in range(0, steps_per_epoch, cfg.steps_per_call):
            metrics = _dispatch(runner, step_by_index, state,
                                np.stack(idxs[c0:c0 + cfg.steps_per_call]),
                                None, cfg.seed, epoch, c0, dp, 1)
            step_losses.append(
                metrics["cls_loss"].reshape(1) if runner is None
                else metrics[:, runner.keys.index("cls_loss")])
        losses = AverageMeter()
        # the epoch's one read
        for v in torch.cat(step_losses).to(torch.float64).tolist():
            losses.update(v, batch)
        train_s = time.time() - epoch_t0
        writer.scalar("Train/cls_loss", losses.avg, epoch + 1)
        train_losses.append(losses.avg)

        out = {}
        for name, indices, ds in (("Valid", split.valid, train_ds),
                                  ("Test", np.arange(len(test_data.labels)),
                                   test_ds)):
            avg = _split_results(evaluate, ds, indices, eval_batch, dev, dp)
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
    dp.barrier()
    return {"history": history, "train_losses": train_losses,
            "state": state, "epoch_times": epoch_times}


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau (mode min, factor 0.1, patience 10,
    relative threshold 1e-4) on the host, as a scale of the base rate
    (main_smooth_ELBO_svhn.py:429,130): an improvement counts only where
    ``metric < best * (1 - threshold)``."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


def _smooth_datasets(cfg: SmoothElboConfig, dataset: str, dev):
    """(train set, test set) of the one-stage trainer: MNIST idx or SVHN
    mat files under ``cfg.path_to_data`` (default
    ``<base_path>/dataset/<dataset>``), else, with ``synthetic_data``,
    2,048 / 512 synthetic 32x32 images (seeds 0 and 1); 28x28 MNIST is
    resized to 32x32 on ``dev``, rounded half to even and clipped to
    uint8."""
    data_dir = cfg.path_to_data or os.path.join(cfg.base_path, "dataset",
                                                dataset)
    load = load_mnist if dataset == "mnist" else load_svhn
    try:
        train, test = load(data_dir, train=True), load(data_dir, train=False)
    except FileNotFoundError:
        if not cfg.synthetic_data:
            raise
        shape = (32, 32, 1) if dataset == "mnist" else (32, 32, 3)
        train = synthetic_dataset(2048, shape, 10, seed=0)
        test = synthetic_dataset(512, shape, 10, seed=1)
    if train.images.shape[1] != 32:
        def _resize(ds: ArrayDataset) -> ArrayDataset:
            r = resize_batch(torch.tensor(ds.images, device=dev), 32)
            return ArrayDataset(torch.clamp(torch.round(r), 0, 255).to(
                torch.uint8).cpu().numpy(), ds.labels)
        train, test = _resize(train), _resize(test)
    return train, test


def build_smooth_model(cfg: SmoothElboConfig, dataset: str,
                       device: DeviceLike = None) -> SmoothVAE:
    """The one-stage trainer's ``SmoothVAE`` (MNIST's or SVHN's widths,
    the latent sizes of ``cfg``), initialised from ``cfg.seed``."""
    mcfg = mnist_vae_config() if dataset == "mnist" else svhn_vae_config()
    mcfg.update(latent_cont_dim=cfg.latent_spec_cont,
                disc_dims=tuple(cfg.latent_spec_disc))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return SmoothVAE(**mcfg, device=device)


@exact_f32()
def run_smooth_elbo(cfg: SmoothElboConfig, dataset: str = "mnist", *,
                    max_epochs: Optional[int] = None, log_fn=print,
                    device: DeviceLike = None) -> dict:
    """Train the one-stage smooth-ELBO VAE on ``dataset`` ('mnist' or
    'svhn') on ``device`` (None: ``cuda``; the CPU only where the caller
    passes ``device="cpu"``), in float32, with Adam and, with
    ``use_plateau_scheduler``, the plateau scale applied from the next
    epoch. Writes ``<DATASET>-One-Stage-VAE/<DATASET>-One-Stage-VAE.txt``
    and, at the end, one checkpoint under the tag ``One-Stage-VAE``.
    Returns ``{"history", "state", "log_path", "epoch_times"}``:
    ``history`` as the JAX loop's, ``epoch_times`` each epoch's ``train_s``
    (up to the train metrics' read) and ``eval_s``."""
    dev = resolve_device(device)
    refuse_ranks("the smooth-ELBO trainer")
    if dataset not in ("mnist", "svhn"):
        raise ValueError(f"dataset {dataset!r}: 'mnist' or 'svhn'")
    train, test = _smooth_datasets(cfg, dataset, dev)
    labeled_idx = labeled_subset_per_class(train.labels,
                                           cfg.size_labeled_data, 10,
                                           seed=cfg.seed)
    unlabeled_idx = np.arange(len(train.labels))
    log_fn(f"labeled size {len(labeled_idx)} unlabeled size "
           f"{len(unlabeled_idx)} dev size {len(test.labels)}")
    train_ds = DeviceDataset(train, device=dev)
    test_ds = DeviceDataset(test, device=dev)

    model = build_smooth_model(cfg, dataset, dev)
    state = TrainState(model, adam_torch(model, cfg.learning_rate))
    plateau = ReduceLROnPlateau() if cfg.use_plateau_scheduler else None
    step = make_smooth_elbo_train_step(
        model, state.optimizer, alpha=cfg.alpha,
        cont_capacity=tuple(cfg.cont_capacity),
        disc_capacity=tuple(cfg.disc_capacity),
        disc_dims=tuple(cfg.latent_spec_disc))
    evaluate = make_smooth_elbo_eval_step(model)

    name = f"{dataset.upper()}-One-Stage-VAE"
    save_dir = os.path.join(cfg.base_path, name)
    os.makedirs(save_dir, exist_ok=True)
    log_path = os.path.join(save_dir, f"{name}.txt")
    rng_u = np.random.default_rng(cfg.seed + 1)
    labeled_iter = infinite_batches(np.random.default_rng(cfg.seed + 2),
                                    labeled_idx, cfg.labeled_batch_size)
    history, epoch_times = [], []
    total_epochs = max_epochs if max_epochs is not None else cfg.epochs
    lr_scale = 1.0
    with open(log_path, "w") as logf:
        for epoch in range(total_epochs):
            epoch_t0 = time.time()
            for group in state.optimizer.param_groups:
                group["lr"] = cfg.learning_rate * lr_scale
            step_metrics = []
            for i, idx_u in enumerate(epoch_batches(
                    rng_u, unlabeled_idx, cfg.unlabeled_batch_size)):
                img_u, _ = train_ds.gather(idx_u)
                img_l, lab_l = train_ds.gather(next(labeled_iter))
                metrics = step(state, img_u, img_l, lab_l,
                               step_generator(cfg.seed, epoch, i))
                step_metrics.append({k: v for k, v in metrics.items()
                                     if v.dim() == 0})
            nb = len(step_metrics)
            # the epoch's one read
            sums = ({k: float(v) for k, v in _summed(step_metrics).items()}
                    if nb else {})
            train_s = time.time() - epoch_t0
            test_acc = _split_results(
                evaluate, test_ds, np.arange(len(test.labels)),
                cfg.test_batch_size, dev)["correct_rate"]
            mean_loss = sums.get("loss", 0.0) / max(nb, 1)
            mean = lambda k: sums.get(k, 0) / nb  # noqa: E731
            tmp = (f"Epoch: {epoch} Average loss: {mean_loss:.2f} "
                   f"Test Accuracy: {test_acc}\n")
            tmp += (f"u_recon_loss: {mean('u_recon'):.2f}, "
                    f"u_cont: {mean('u_cont_cap'):.2f}, "
                    f"u_disc: {mean('u_disc_cap'):.2f}\n")
            tmp += (f"l_recon_loss: {mean('l_recon'):.2f}, "
                    f"l_cont: {mean('l_cont_cap'):.2f}, "
                    f"l_disc: {mean('l_disc_cap'):.2f}, "
                    f"class: {mean('classification'):.2f}\n")
            log_fn(tmp)
            logf.write(tmp + "\n")
            history.append({"epoch": epoch, "test_acc": float(test_acc),
                            "mean_loss": mean_loss,
                            "train_terms": {k: v / max(nb, 1)
                                            for k, v in sums.items()},
                            "lr_scale": float(lr_scale)})
            epoch_times.append({"train_s": train_s,
                                "eval_s": time.time() - epoch_t0 - train_s})
            if plateau is not None:
                lr_scale = plateau.step(mean_loss)

    ckpt = CheckpointManager(cfg.base_path, dataset.upper(), cfg.train_time,
                             tag="One-Stage-VAE")
    ckpt.save(state, epoch=total_epochs, config=cfg.asdict())
    ckpt.wait_until_finished()  # the write lands before the return
    return {"history": history, "state": state, "log_path": log_path,
            "epoch_times": epoch_times}


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
