"""The rank side of tests/test_torch_parallel.py: what each of the ranks
that ``shotvae_torch.parallel.spawn_ranks`` starts runs. It imports only
torch, numpy and the port (the ranks are fresh processes), reads its jobs
from ``<folder>/jobs.pt`` and writes what it computed to
``<folder>/rank<r>.pt``."""

from __future__ import annotations

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
    """What the data-parallel entry points raise inside a group: ``--dp``
    above one rank, and ``--num-devices`` other than the world size."""
    from shotvae_torch.cli.main_shot_vae import main

    out = {}
    for name, flags in (("dp", ["--dp"]), ("num_devices",
                                           ["--num-devices", "3"])):
        try:
            main([*job["argv"], *flags], device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
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


PARTS = {"bn_sites": bn_sites, "mixups": mixups, "refusals": refusals,
         "epoch_and_resume": epoch_and_resume}


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
