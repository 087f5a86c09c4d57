"""The ``train_epochs`` traffic: whole SHOT-VAE epochs, back to back, as
the port's loop runs them (shotvae_torch/train/loop.py ``run_shot_vae``,
:354-445), with TensorBoard, the reconstruction grid, the log and the
checkpoints left out.

Set-up builds the model, its SGD state and one ``ChunkRunner``, loads the
benchmark's weights and runs epoch 0 whole: the runner's eager first chunk,
the captures of both chunk lengths (the first replay of the full length is
epoch 0's second chunk) and the eval step's first calls. The reference
follows epoch 0's first two chunks, the eager one and that replay, and is
held to the state they leave. The window then runs whole epochs until
``seconds`` have passed, finishing the epoch in progress, so every epoch's
eval pass is in it. A traced run traces ``traced_epochs`` whole epochs in
place of the window. After it the reference's eval pass, from the state
the program held at the window's first eval pass (kept by one clone on the
card between the epochs), is held to that pass's sums over the valid
split.

Each epoch: the index chunks of ``shot_vae_chunks``, one
``ChunkRunner.run`` per chunk on the generators of ``step_generators``, the
train metrics read once, then ``make_vae_eval_step`` over the valid split
and the test set in padded batches, each split's sums read once.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench.lib import check, inputs
from portbench.lib.trace import span, traced
from portbench.reference import shot_step
from portbench.reference.eval_pass import eval_sums
from portbench.reference.model import param_spec

CHECKED_CHUNKS = 2  # the eager first chunk and the first full replay
CHECKED_EVAL = 1    # the window's first epoch, whose eval pass is compared


def _padded_eval_batches(indices: np.ndarray, batch: int):
    """Fixed-size eval batches and 0/1 weights, the tail padded by
    wrap-around (a copy of shotvae_torch/train/loop.py:115-125)."""
    for start in range(0, len(indices), batch):
        idx = indices[start:start + batch]
        real = len(idx)
        weight = np.ones(batch, np.float32)
        if real < batch:
            idx = np.concatenate([idx, np.resize(idx, batch - real)])
            weight[real:] = 0.0
        yield idx, weight


def _summed(rows) -> dict:
    """The sums of a list of metric dicts of 0-d tensors, in float64 on
    their device (shotvae_torch/train/loop.py:189-198)."""
    keys = list(rows[0])
    table = torch.stack([torch.stack([r[k] for k in keys]) for r in rows])
    return dict(zip(keys, table.to(torch.float64).sum(0).unbind()))


def phase(name: str, t_start: float) -> None:
    """Mark a step of set-up on standard error, in seconds since the
    process started."""
    print(f"setup {name} {time.time() - t_start:.3f}", file=sys.stderr)


def port_config(cell):
    from shotvae_torch.config import ShotVaeConfig

    cli = dict(cell.config["cli"], **cell.sizes.get("cli", {}))
    return ShotVaeConfig(**cli, seed=cell.seed, ckpt_every=0)


def _program(cell, dev, t_start: float) -> dict:
    """Set-up, the window and what the check needs of the program; every
    device object of the program is freed on return."""
    from shotvae_torch.data.datasets import ArrayDataset
    from shotvae_torch.data.pipeline import DeviceDataset, num_batches
    from shotvae_torch.data.splits import ssl_split
    from shotvae_torch.ops.schedules import shot_vae_epoch_schedules
    from shotvae_torch.parallel.mesh import setup
    from shotvae_torch.train.chunk import ChunkRunner
    from shotvae_torch.train.loop import (EVAL_KEY, build_model, build_state,
                                          shot_vae_chunks, step_generators)
    from shotvae_torch.train.steps import (make_shot_vae_train_step,
                                           make_vae_eval_step)
    from shotvae_torch.utils.meters import MetricAccumulator

    phase("imports", t_start)
    model_cfg = cell.config["model"]
    data_cfg = dict(cell.config["data"], **cell.sizes.get("data", {}))
    cfg = port_config(cell)
    dp = setup(cfg, dev)
    spec = cfg.apply_dataset_overrides()
    data = inputs.dataset(cell.seed, data_cfg, model_cfg, dev)

    def resident(split):
        images, labels = data[split]
        return (ArrayDataset(images.cpu().numpy(),
                             labels.cpu().numpy().astype(np.int32)))

    train_np, test_np = resident("train"), resident("test")
    del data
    split = ssl_split(train_np.labels, spec.valid_per_class,
                      spec.annotated_per_class, spec.num_classes,
                      seed=cfg.seed)
    train_ds = DeviceDataset(train_np, device=dev)
    test_ds = DeviceDataset(test_np, device=dev)
    test_idx = np.arange(len(test_np.labels))

    phase("data", t_start)
    model = build_model(cfg, spec, dev)
    p0 = inputs.weights(cell.seed, param_spec(model_cfg), dev)
    model.load_state_dict(p0, strict=True)
    p0 = {n: v.cpu() for n, v in p0.items()}
    batch = cfg.batch_size
    local = batch // dp.world_size
    steps_per_epoch = num_batches(len(split.unlabeled), batch)
    state = build_state(model, cfg, steps_per_epoch)
    step = make_shot_vae_train_step(
        model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
        x_sigma=cfg.x_sigma, epsilon=cfg.epsilon, optimal_match=cfg.om,
        global_mixup=cfg.global_mixup, dp=dp,
        bn_per_replica=cfg.bn_per_replica)
    evaluate = make_vae_eval_step(model, num_classes=spec.num_classes,
                                  bce=cfg.br, x_sigma=cfg.x_sigma)
    params = dict(model.named_parameters())
    faults = cell.faults()
    if "decoder" in faults:  # a wrong gradient of the decoder's weights
        for name, p in params.items():
            if name.startswith("feature_reconstructor"):
                p.register_hook(lambda g: 0.5 * g)
    snap = {}

    def momentum_now() -> dict:
        opt = state.optimizer.state
        return {n: opt[p]["momentum_buffer"].detach().clone()
                for n, p in params.items()}

    def state_now() -> dict:
        """Clones of the parameters and their momentum, in stream
        order."""
        return {"params": {n: p.detach().clone() for n, p in params.items()},
                "momentum": momentum_now()}

    half = local // 2

    def step_by_index(state, idx, sched, gen, inject=None, shared=None):
        images, labels = train_ds.gather(idx)
        if "half" in faults:  # half of each stream left out
            images = torch.cat([images[:half], images[local:local + half]])
            labels = torch.cat([labels[:half], labels[local:local + half]])
            n = half
        else:
            n = local
        frozen = ([t.detach().clone() for t in model.state_dict().values()]
                  if "frozen" in faults else None)
        out = step(state, images[:n], labels[:n], images[n:], labels[n:],
                   sched, gen, inject=inject, shared_generator=shared)
        if frozen is not None:  # a step that leaves its state unchanged
            with torch.no_grad():
                for t, v in zip(model.state_dict().values(), frozen):
                    t.copy_(v)
        if "first" not in snap:  # the momentum after the first step
            snap["first"] = momentum_now()
        return out

    runner = ChunkRunner(step_by_index, dev, steps=cfg.steps_per_call,
                         width=2 * local, dp=dp)
    counts = {"steps": 0, "eval_forwards": 0, "chunks": 0, "failed": 0,
              "epochs": 0}
    epoch_tables = []

    def epoch_body(epoch: int) -> None:
        sched = shot_vae_epoch_schedules(epoch, cfg)
        runner.set_sched(sched)
        rows = []
        for c, (c0, idx) in enumerate(shot_vae_chunks(
                cfg.seed, epoch, split.labeled, split.unlabeled, batch,
                cfg.steps_per_call)):
            local_rows = np.stack([np.concatenate(
                [dp.shard(b) for b in np.split(row, 2)]) for row in idx])
            keys = [step_generators(cfg.seed, epoch, i, dp)
                    for i in range(c0, c0 + len(idx))]
            with span("runner.run"):
                rows.append(runner.run(state, local_rows, keys))
            counts["chunks"] += 1
            if epoch == 0 and c == CHECKED_CHUNKS - 1:
                snap["checked"] = state_now()
                snap["steps"] = c0 + len(idx)
        with span("train.read"):  # the epoch's one read
            table = torch.cat(rows).cpu()
        if not epoch_tables:
            epoch_tables.append(table)
        loss = table[:, runner.keys.index("loss")]
        counts["steps"] += len(loss)
        counts["failed"] += int((~torch.isfinite(loss)).sum())
        with span("eval"):
            for name, ds, indices in (("valid", train_ds, split.valid),
                                      ("test", test_ds, test_idx)):
                batch_metrics = []
                for j, (idx, weight) in enumerate(
                        _padded_eval_batches(indices, batch)):
                    if "padding" in faults:  # the padding rows counted
                        weight = np.ones_like(weight)
                    img, lab = ds.gather(dp.shard(idx))
                    metrics, _ = evaluate(
                        img, lab, torch.from_numpy(dp.shard(weight)).to(
                            dev, non_blocking=True),
                        generator=step_generators(cfg.seed, epoch,
                                                  EVAL_KEY + j, dp)[0])
                    batch_metrics.append(metrics)
                    counts["eval_forwards"] += 1
                acc = MetricAccumulator()
                with span("eval.read"):  # the split's one read
                    acc.update(dp.sum_metrics(_summed(batch_metrics)))
                if name == "valid" and epoch == CHECKED_EVAL:
                    # eval moves no state: this is the state it read
                    snap["eval"] = dict(acc.totals)
                    snap["eval_state"] = {
                        n: v.detach().clone()
                        for n, v in model.state_dict().items()}
        counts["epochs"] += 1

    phase("model", t_start)
    epoch_body(0)  # set-up: the eager chunk, both captures, the eval step
    phase("epoch0", t_start)
    first, checked, steps = snap.pop("first"), snap.pop("checked"), \
        snap.pop("steps")
    program = {
        "losses": epoch_tables[0][:steps, runner.keys.index("loss")].tolist(),
        "grad": {n: first[n].double().cpu()
                 - cfg.wd * p0[n].double() for n in params},
        "change": {n: v.double().cpu() - p0[n].double()
                   for n, v in checked["params"].items()},
        "momentum": {n: v.double().cpu()
                     for n, v in checked["momentum"].items()},
    }
    del first, checked
    out = {"program": program, "checked_steps": steps}
    counts.update(dict.fromkeys(counts, 0))
    epoch = 1
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out["setup_s"] = time.time() - t_start
    if cell.trace:
        with traced() as holder:
            for _ in range(cell.traffic["traced_epochs"]):
                epoch_body(epoch)
                epoch += 1
        out["trace"] = holder.trace
    else:
        t0 = time.perf_counter()
        while True:
            epoch_body(epoch)
            epoch += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        out["window_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        # what the process holds on the card, the graphs' pool included
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(dev)
    program["eval"] = snap.pop("eval")
    out["eval_state"] = {n: v.cpu() for n, v in snap.pop("eval_state").items()}
    out["eval_epoch"] = CHECKED_EVAL
    out["counts"] = dict(counts)
    out["batch"] = batch
    return out


def drive(cell, dev, t_start: float) -> dict:
    """Run the cell: its end-to-end ``metrics`` (untraced) or ``trace``,
    ``counts``, ``attempted`` and ``failed``, and what the program and the
    reference give the check (``program``, ``reference``)."""
    from shotvae_torch.device import exact_f32

    with exact_f32():
        run = _program(cell, dev, t_start)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run["reference"] = reference(cell, dev, run["checked_steps"])
    run["reference"]["eval"] = reference_eval(cell, dev, run["eval_state"],
                                              run["eval_epoch"])
    counts = run["counts"]
    if not cell.trace:
        images = counts["steps"] * run["batch"]
        run["metrics"] = {"train_img_per_s": images / run["window_s"],
                          "train_peak_gb": run.get("memory_peak_bytes",
                                                   math.nan) / 1e9}
    run["attempted"], run["failed"] = counts["steps"], counts["failed"]
    return run


def numbers(run: dict) -> dict:
    return check.train_numbers(run["program"], run["reference"])


def control(cell, dev, run: dict) -> dict:
    """The plain reference one precision below the configuration's, put in
    the program's place: its state after the checked steps and its eval
    sums from the program's state (control.py)."""
    trunk = check.LOWER[cell.config["precision"]["train_trunk"]]
    low = reference(cell, dev, run["checked_steps"], trunk)
    low["eval"] = reference_eval(cell, dev, run["eval_state"],
                                 run["eval_epoch"], trunk)
    return low


def _reference_cli(cell) -> dict:
    return {**cell.config["cli"], **cell.config["derived"],
            **cell.sizes.get("cli", {}), **cell.sizes.get("derived", {})}


def _train_split(cell, dev):
    data_cfg = dict(cell.config["data"], **cell.sizes.get("data", {}))
    return inputs.dataset(cell.seed, data_cfg, cell.config["model"],
                          dev)["train"]


def reference(cell, dev, steps: int, trunk: str = None) -> dict:
    """The plain reference's first ``steps`` steps from the benchmark's
    inputs (regenerated from the seed), at ``trunk`` (default: the
    configuration's training precision)."""
    model_cfg = cell.config["model"]
    trunk = trunk or cell.config["precision"]["train_trunk"]
    images, labels = _train_split(cell, dev)
    spec = param_spec(model_cfg)
    t = inputs.weights(cell.seed, spec, dev)
    p0 = {n: t[n].detach().clone() for n in inputs.trainable(spec)}
    for n in p0:
        t[n].requires_grad_(True)
    losses, grad, momentum = shot_step.first_steps(
        t, model_cfg, _reference_cli(cell), trunk, images, labels, cell.seed,
        steps)
    return {"losses": losses,
            "grad": {n: g.double().cpu() for n, g in grad.items()},
            "change": {n: (t[n].detach() - p0[n]).double().cpu()
                       for n in p0},
            "momentum": {n: m.double().cpu() for n, m in momentum.items()}}


def reference_eval(cell, dev, state: dict, epoch: int,
                   trunk: str = None) -> dict:
    """The plain reference's eval sums over the valid split, from the
    program's ``state`` at the eval pass of ``epoch``: the reference can
    follow the window's epochs only from the program's own state."""
    model_cfg = cell.config["model"]
    cli = _reference_cli(cell)
    trunk = trunk or cell.config["precision"]["train_trunk"]
    images, labels = _train_split(cell, dev)
    valid, _, _ = shot_step.ssl_split(
        labels.cpu().numpy(), cli["valid_per_class"],
        cli["labeled_per_class"], model_cfg["num_classes"], cell.seed)
    t = {n: v.to(dev) for n, v in state.items()}
    return eval_sums(t, model_cfg, trunk, images, valid,
                     seed=cell.seed, epoch=epoch, batch=cli["batch_size"],
                     x_sigma=cli["x_sigma"])
