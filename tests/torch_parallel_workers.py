"""The rank side of tests/test_torch_parallel.py: what each of the ranks
that ``shotvae_torch.parallel.spawn_ranks`` starts runs. It imports only
torch, numpy and the port (the ranks are fresh processes), reads its jobs
from ``<folder>/jobs.pt`` and writes what it computed to
``<folder>/rank<r>.pt``."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

NET = "wideresnet-10-1"
DC, K = 8, 10
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)


def vae(state_dict=None, dtype=None):
    from shotvae_torch.models.vae import VariationalAutoEncoder

    model = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                   disc_latent_dim=K, device="cpu",
                                   dtype=dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def classifier(state_dict=None):
    from shotvae_torch.models.classifier import build_classifier

    model = build_classifier(NET, K, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def train_once(job: dict, dp=None) -> dict:
    """One train step of ``job`` (``kind`` ``shot``, with
    ``fused_streams`` the fused two-stream step, ``m2`` or
    ``classifier``) on the rows of this rank of ``dp`` (None: the whole
    batch in one process): the metrics, every parameter's gradient (after
    the mean over the ranks), and the state dict after the update."""
    from shotvae_torch.ops.schedules import multistep_lr
    from shotvae_torch.train.state import TrainState, sgd_torch
    from shotvae_torch.train import steps

    kind = job["kind"]
    model = (classifier if kind == "classifier" else vae)(job["state_dict"])
    opt = sgd_torch(model)
    state = TrainState(model, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    ranks = dict(dp=dp, bn_per_replica=job.get("bn_per_replica", False),
                 bn_stats=job.get("bn_stats", "replica0"))
    data = [job["batch"][k] for k in (("img", "lab") if kind == "classifier"
                                      else ("img_l", "lab_l", "img_u",
                                            "lab_u"))]
    if dp is not None:
        data = [dp.shard(a) for a in data]
    gen = torch.Generator().manual_seed(job.get("seed", 0)
                                        + (dp.rank if dp else 0))
    if kind == "classifier":
        step = steps.make_classifier_train_step(model, opt, **ranks)
        metrics = step(state, *map(torch.as_tensor, data), gen,
                       inject=job.get("inject"))
    else:
        common = dict(num_classes=K, bce=True, x_sigma=1.0,
                      aug=job.get("aug", True), **ranks)
        if kind == "m2":
            step = steps.make_m2_train_step(model, opt, **common)
            kw = {}
        else:
            step = steps.make_shot_vae_train_step(
                model, opt, epsilon=0.1, optimal_match=job.get("om", True),
                fused_streams=job.get("fused_streams", False),
                global_mixup=job.get("global_mixup", False), **common)
            kw = {"shared_generator": torch.Generator().manual_seed(
                job.get("shared_seed", 1))}
        metrics = step(state, *map(torch.as_tensor, data), SCHED, gen,
                       inject=job.get("inject"), **kw)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def bn_sites(job: dict, dp) -> dict:
    """The sync-BN ``bn_leaky_train`` and ``fused_bn_act_conv_train`` on
    this rank's rows: y, mean, var, dx, and dgamma / dbeta after the mean
    over the ranks."""
    from shotvae_torch.ops.kernels.bn_leaky import bn_leaky_train
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv_train

    out = {}
    for name in ("bn_leaky", "fused_conv"):
        x = dp.shard(job[name]["x"]).clone().requires_grad_(True)
        gamma = job[name]["gamma"].clone().requires_grad_(True)
        beta = job[name]["beta"].clone().requires_grad_(True)
        g = dp.shard(job[name]["g"])
        if name == "bn_leaky":
            y, mean, var = bn_leaky_train(x, gamma, beta, group=dp.group)
        else:
            y, mean, var = fused_bn_act_conv_train(
                x, gamma, beta, job[name]["w"], group=dp.group)
        y.backward(g)
        dgamma, dbeta = gamma.grad.clone(), beta.grad.clone()
        dp.all_reduce_(dgamma, mean=True)
        dp.all_reduce_(dbeta, mean=True)
        out[name] = dict(y=y.detach(), mean=mean, var=var, dx=x.grad,
                         dgamma=dgamma, dbeta=dbeta)
    return out


def mixups(job: dict, dp) -> dict:
    """``gather_mixup`` of both interpolations on this rank's rows with the
    shared generator: this rank's rows of each output."""
    from shotvae_torch.ops import mixup

    a = [dp.shard(job["mixup"][k]) for k in ("x", "mean", "ls", "la",
                                             "lab")]
    out = {}
    for name, fn, arrays, kw in (
            ("label_smoothing", mixup.label_smoothing, a, {"epsilon": 0.1}),
            ("mixup_vae_data", mixup.mixup_vae_data, a[:4],
             {"optimal_match": False}),
            ("optimal_match", mixup.mixup_vae_data, a[:4],
             {"optimal_match": True})):
        gen = torch.Generator().manual_seed(job["mixup"]["seed"])
        out[name] = mixup.gather_mixup(dp, fn, arrays, generator=gen, **kw)
    return out


def refusals(job: dict, dp) -> dict:
    """What the data-parallel entry points do inside a group: ``--dp``
    above one rank and ``--num-devices`` other than the world size raise;
    ``--steps-per-call 4`` runs (one tiny epoch, under this rank's own
    base path): its history, or what it raised."""
    from shotvae_torch.cli.main_shot_vae import main

    out = {}
    spc = ["-bp", os.path.join(job["folder"], f"spc{dp.rank}"),
           *job["spc_argv"]]
    for name, argv in (("dp", [*job["argv"], "--dp"]),
                       ("num_devices", [*job["argv"], "--num-devices", "3"]),
                       ("steps_per_call", spc)):
        try:
            out[name] = main(argv, device="cpu")["history"]
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def epoch_and_resume(job: dict, dp) -> dict:
    """A tiny two-epoch ``run_shot_vae`` under this rank's own base path,
    then its second epoch again, resumed on every rank from rank 0's
    checkpoint of the first: both histories, the final state dicts, and
    the files this rank's base path holds."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.train.loop import run_shot_vae

    base = os.path.join(job["folder"], f"base{dp.rank}")
    os.makedirs(base, exist_ok=True)
    quiet = lambda *a: None  # noqa: E731
    straight = run_shot_vae(ShotVaeConfig(**dict(job["config"],
                                                 base_path=base)),
                            max_epochs=2, device="cpu", log_fn=quiet)
    files = sorted(os.path.relpath(os.path.join(d, f), base)
                   for d, _, fs in os.walk(base) for f in fs)
    first = os.path.join(job["folder"], "base0", "Cifar10-SHOT-VAE",
                         "parameter", "train_time_1",
                         "checkpoint.slot0.pth.tar")  # epoch 1's
    resumed = run_shot_vae(ShotVaeConfig(**dict(job["config"],
                                                base_path=base,
                                                resume=first)),
                           max_epochs=2, device="cpu", log_fn=quiet)
    state = lambda out: {k: v.clone() for k, v in  # noqa: E731
                         out["state"].model.state_dict().items()}
    return {"straight": straight["history"], "resumed": resumed["history"],
            "files": files, "state": state(resumed),
            "straight_state": state(straight)}


def _tensors_of(state) -> dict:
    """Every tensor of a train state: the model's state dict and SGD's
    momentum buffers."""
    out = dict(state.model.state_dict())
    out.update({f"momentum {i}": st["momentum_buffer"] for i, st in
                state.optimizer.state_dict()["state"].items()})
    return out


def _digest(tensors: dict) -> str:
    """A SHA-256 over the names, dtypes, shapes and bytes of ``tensors``."""
    h = hashlib.sha256()
    for k, v in tensors.items():
        v = v.detach().contiguous()
        h.update(f"{k} {v.dtype} {tuple(v.shape)}".encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def chunked(job: dict, dp) -> dict:
    """``--steps-per-call``: each case of ``job["cases"]`` ({name: (kind,
    config fields)}), one tiny epoch at N = 1 and at ``job["n"]`` under
    this rank's own base path, TensorBoard off, compared here (the states
    are large): {name: {"differ": the tensors of the final states
    (parameters, buffers, momentum) that differ in any bit, "tensors":
    their number, "momenta": the momentum buffers', "digest": the N run's
    (``_digest``, held across the ranks), and by N: ``state.step``, the
    history (but its seconds) and the collectives counted}}."""
    from shotvae_torch.config import ClassifierConfig, ShotVaeConfig
    from shotvae_torch.io.tb import TBWriter
    from shotvae_torch.parallel import DataParallel
    from shotvae_torch.train import loop

    writer, loop.TBWriter = loop.TBWriter, (
        lambda log_dir, enabled=True: TBWriter(log_dir, False))
    out = {}
    try:
        for name, (kind, fields) in job["cases"].items():
            res, tensors = {"step": {}, "history": {}, "collectives": {}}, {}
            for n in (1, job["n"]):
                base = os.path.join(job["folder"], f"{name}{n}_{dp.rank}")
                cfg = (ClassifierConfig if kind == "classifier"
                       else ShotVaeConfig)(base_path=base, steps_per_call=n,
                                           **fields)
                before = DataParallel.collectives
                run = (loop.run_classifier(cfg, max_epochs=1, device="cpu",
                                           log_fn=lambda *a: None)
                       if kind == "classifier" else
                       loop.run_shot_vae(cfg, m2=kind == "m2", max_epochs=1,
                                         device="cpu",
                                         log_fn=lambda *a: None))
                res["collectives"][n] = DataParallel.collectives - before
                res["step"][n] = run["state"].step
                res["history"][n] = [{k: v for k, v in h.items()
                                      if k != "seconds"}
                                     for h in run["history"]]
                tensors[n] = _tensors_of(run["state"])
            one, many = tensors[1], tensors[job["n"]]
            res.update(
                differ=sorted(set(one) ^ set(many)) + [
                    k for k in one if k in many
                    and not torch.equal(one[k], many[k])],
                tensors=len(one), digest=_digest(many),
                momenta=sum(k.startswith("momentum ") for k in one))
            out[name] = res
    finally:
        loop.TBWriter = writer
    return out


def injected_chunk(job: dict, dp) -> dict:
    """Three SHOT-VAE steps of each of ``job["steps"]`` ({name: step job,
    as ``train_once`` takes, with its three global draws under
    ``injects``}) through a chunk runner over the ranks, a chunk of 2
    (eager) and a tail of 1 (the static inputs), each step on this rank's
    rows and the LR of ``multistep_lr(0.1, [1], 1)``: each step's metrics
    and the state dict after each chunk."""
    from shotvae_torch.data.datasets import ArrayDataset
    from shotvae_torch.data.pipeline import DeviceDataset
    from shotvae_torch.ops.schedules import multistep_lr
    from shotvae_torch.train import steps
    from shotvae_torch.train.chunk import ChunkRunner
    from shotvae_torch.train.state import TrainState, sgd_torch

    out = {}
    for name, sj in job["steps"].items():
        b = len(sj["batch"]["img_l"])
        ds = DeviceDataset(ArrayDataset(
            np.concatenate([sj["batch"]["img_l"], sj["batch"]["img_u"]]),
            np.concatenate([sj["batch"]["lab_l"], sj["batch"]["lab_u"]])),
            device="cpu")
        model = vae(sj["state_dict"])
        opt = sgd_torch(model)
        state = TrainState(model, opt, multistep_lr(0.1, [1],
                                                    steps_per_epoch=1))
        step = steps.make_shot_vae_train_step(
            model, opt, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
            optimal_match=True, aug=False, dp=dp,
            bn_per_replica=sj.get("bn_per_replica", False),
            bn_stats=sj.get("bn_stats", "replica0"),
            global_mixup=sj.get("global_mixup", False))
        local = b // dp.world_size

        def step_by_index(state, idx, sched, draws, inject=None,
                          shared=None):
            images, labels = ds.gather(idx)
            return step(state, images[:local], labels[:local],
                        images[local:], labels[local:], sched, draws,
                        inject=inject, shared_generator=shared)

        runner = ChunkRunner(step_by_index, "cpu", steps=2, width=2 * local,
                             dp=dp)
        runner.set_sched(SCHED)
        row = np.concatenate([dp.shard(np.arange(b)),
                              b + dp.shard(np.arange(b))])
        metrics, states = [], []
        for c0, n in ((0, 2), (2, 1)):
            gens = [(torch.Generator().manual_seed(c0 + j),
                     torch.Generator().manual_seed(100 + c0 + j))
                    for j in range(n)]
            got = runner.run(state, np.tile(row, (n, 1)), gens,
                             sj["injects"][c0:c0 + n])
            metrics += [dict(zip(runner.keys, m.tolist())) for m in got]
            states.append({k: v.clone()
                           for k, v in model.state_dict().items()})
        out[name] = {"metrics": metrics, "states": states,
                     "graphs": sorted(runner.graphs), "step": state.step}
    return out


PARTS = {"bn_sites": bn_sites, "mixups": mixups, "refusals": refusals,
         "epoch_and_resume": epoch_and_resume, "chunked": chunked,
         "injected_chunk": injected_chunk}


def run(rank: int, world: int, folder: str) -> None:
    """Every job of ``<folder>/jobs.pt`` on this rank: the named parts and
    the train steps (``steps``: {name: job})."""
    from shotvae_torch.parallel import DataParallel

    torch.set_num_threads(1)
    jobs = torch.load(os.path.join(folder, "jobs.pt"), weights_only=False)
    dp = DataParallel(dist.group.WORLD)
    out = {name: PARTS[name](dict(job, folder=folder), dp)
           for name, job in jobs.get("parts", {}).items()}
    out["steps"] = {name: train_once(job, dp)
                    for name, job in jobs.get("steps", {}).items()}
    out["world"] = (dp.rank, dp.world_size)
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    if jobs.get("fail_on_rank") == rank:
        raise RuntimeError(f"rank {rank} fails, as the job asks")


def numpy_batch(rng: np.random.Generator, b: int) -> dict:
    """Seeded uint8 images and labels of both streams."""
    return {"img_l": rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
            "img_u": rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, b).astype(np.int64),
            "lab_u": rng.integers(0, K, b).astype(np.int64)}
