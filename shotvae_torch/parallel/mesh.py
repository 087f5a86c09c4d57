"""Data parallelism: one process per card over ``torch.distributed``.

Port of shotvae_tpu/parallel/mesh.py:1-139 and the ``axis_name`` paths of
shotvae_tpu/train/steps.py:47-105. The JAX package runs one program over a
1-D device mesh in two modes, and so does this one, with one rank per card
(``torchrun --nproc-per-node N``):

* sync-BN, the default (the JAX package's GSPMD ``jit_step``): every
  BatchNorm site pools its statistics over the global batch. The
  collectives sit inside the hand kernels' autograd Functions
  (``ops/kernels/bn_leaky.py``, ``ops/kernels/fused_conv.py``): one
  all-reduce of the per-channel sums before the apply, one of the backward
  sums before dx. Mixup's weight, its partners and the optimal match span
  the global batch (``gather_rows``), and a batch-mean term that the loss
  takes through a non-linear function (the ELBO's mutual-information
  hinges) is the global mean (``global_mean``);
* per-replica BN (``--bn-per-replica``, ``shard_map_step``): each rank
  normalises with its own rows' statistics and, unless ``--global-mixup``,
  mixes within its rows; the running statistics follow ``bn_stats``
  (``"replica0"``: rank 0's, broadcast; ``"mean"``: the mean over ranks).

In both, the gradients are averaged over the ranks once, after the step's
one backward (the JAX step's ``pmean``), and so are the metrics. Every rank
draws the same global index batch from the same numpy stream and takes its
rows ``r*B/W : (r+1)*B/W`` (``shard``). The per-row draws (crops, flips,
latent noise, dropout) come from a generator of the rank's own
(``rank_generator``); the draws that span the global batch from one every
rank shares. With no process group (one card, no launcher) nothing here
issues a collective, and the step is exactly the single-card step.

Every rank must issue the same collectives in the same order; a rank that
fails leaves the others waiting until the group's timeout
(``COLLECTIVE_TIMEOUT_S``). ``spawn_ranks`` runs W ranks of one function on
one host and fails where any rank fails or the run outlasts its limit.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 600
BN_STATS_POLICIES = ("replica0", "mean")


class DataParallel:
    """The ranks of one process group (None: one process, no collective).

    A group of one rank still issues every collective, so the group path
    can be checked on a single card."""

    def __init__(self, group=None):
        self.group = group
        self.world_size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run's files and logs."""
        return self.rank == 0

    def pad_batch_size(self, n: int) -> int:
        """Round a batch size up to a multiple of the world size."""
        return -(-n // self.world_size) * self.world_size

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.world_size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.world_size} ranks")
        local = n // self.world_size
        return slice(self.rank * local, (self.rank + 1) * local)

    def shard(self, batch):
        """This rank's rows of a global batch (numpy or torch, rows
        first)."""
        return batch[self.rows(len(batch))]

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def all_reduce_(self, t: torch.Tensor, mean: bool = False
                    ) -> torch.Tensor:
        """Sum (or mean) ``t`` over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
            if mean:
                t.div_(self.world_size)
        return t

    def mean_gradients(self, params) -> None:
        """Each parameter's gradient averaged over the ranks: one flat
        all-reduce (the JAX step's ``pmean`` of the gradients)."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat, mean=True)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()

    def mean_metrics(self, metrics: dict) -> dict:
        """{name: 0-d tensor} averaged over the ranks in one all-reduce."""
        if self.group is None or not metrics:
            return metrics
        keys = list(metrics)
        table = torch.stack([metrics[k].detach().to(torch.float32)
                             for k in keys])
        self.all_reduce_(table, mean=True)
        return dict(zip(keys, table.unbind()))

    def sum_metrics(self, metrics: dict) -> dict:
        """{name: 0-d tensor} summed over the ranks in one all-reduce."""
        if self.group is None or not metrics:
            return metrics
        keys = list(metrics)
        table = torch.stack([metrics[k] for k in keys])
        self.all_reduce_(table)
        return dict(zip(keys, table.unbind()))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in rank order: the global batch.
        Built as a sum of a zero-filled global buffer, which every backend
        takes for every dtype and device (gloo stages a CUDA tensor through
        the host)."""
        if self.group is None:
            return t
        n = t.shape[0]
        out = torch.zeros((n * self.world_size, *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        out[self.rank * n:(self.rank + 1) * n] = t
        return self.all_reduce_(out)

    def sync_running_stats(self, model: torch.nn.Module,
                           policy: str) -> None:
        """The per-replica mode's running statistics after a step:
        ``"replica0"`` copies rank 0's to every rank, ``"mean"`` averages
        them (shotvae_tpu/train/steps.py:52-78)."""
        if policy not in BN_STATS_POLICIES:
            raise ValueError(f"unknown bn_stats policy {policy!r}")
        if self.group is None:
            return
        from shotvae_torch.models.layers import BatchNorm

        bufs = [b for m in model.modules() if isinstance(m, BatchNorm)
                for b in (m.running_mean, m.running_var)]
        if not bufs:
            return
        flat = torch.cat([b.reshape(-1) for b in bufs])
        if policy == "replica0":
            dist.broadcast(flat, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        else:
            self.all_reduce_(flat, mean=True)
        start = 0
        for b in bufs:
            b.copy_(flat[start:start + b.numel()].view_as(b))
            start += b.numel()


class _GlobalMean(torch.autograd.Function):
    """Forward: the mean over the ranks. Backward: the gradient passes on
    unchanged, so that each rank's backward holds W times its share of the
    global loss's gradient, as every other term of its loss does, and the
    gradient mean over the ranks makes it right."""

    @staticmethod
    def forward(ctx, x, dp):
        out = x.detach().clone()
        return dp.all_reduce_(out, mean=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_mean(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """The mean of a rank's batch-mean ``x`` over the ranks: the global
    batch's mean where every rank has as many rows."""
    if dp is None or dp.group is None:
        return x
    return _GlobalMean.apply(x, dp)


def set_bn_group(model: torch.nn.Module, group) -> torch.nn.Module:
    """Give every BatchNorm site of ``model`` the process group its
    train-mode statistics pool over (None: its own rows), as
    ``torch.nn.SyncBatchNorm.convert_sync_batchnorm`` does for torch's own
    BatchNorm."""
    from shotvae_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


def rank_generator(seed: int, epoch: int, i: int,
                   rank: int) -> torch.Generator:
    """The per-row draws' host generator of ``rank`` for train step (or
    eval batch key) ``i`` of ``epoch``, keyed by (seed + 1000, epoch, i,
    rank + 1): no two ranks share a stream, and none shares the
    (seed + 1000, epoch, i) stream that every rank draws its shared draws
    from."""
    state = np.random.SeedSequence([seed + 1000, epoch, i,
                                    rank + 1]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def launcher_env() -> dict:
    """torchrun's description of this process: world size, rank, local
    world size (1, 0, 1 without a launcher)."""
    get = lambda k, d: int(os.environ.get(k, d))  # noqa: E731
    world = get("WORLD_SIZE", 1)
    return {"world_size": world, "rank": get("RANK", 0),
            "local_rank": get("LOCAL_RANK", 0),
            "local_world_size": get("LOCAL_WORLD_SIZE", world)}


def init_from_env(device: torch.device, backend: Optional[str] = None):
    """Join the process group torchrun describes: ``nccl`` for a CUDA
    device (one card per local rank), ``gloo`` where the caller names it
    or the device is the CPU. A failed init raises; there is no fallback
    to another backend or to one rank."""
    env = launcher_env()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(env["local_rank"])
    dist.init_process_group(
        backend, world_size=env["world_size"], rank=env["rank"],
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


_LAUNCH_HINT = ("launch one process per card: torchrun --nproc-per-node N "
                "-m shotvae_torch.cli.main_shot_vae --num-devices N ...")


def setup(cfg, device: torch.device) -> DataParallel:
    """The data-parallel ranks of a trainer's run of ``cfg``: the process
    group already made (by a test or a launcher script), else the one
    torchrun describes (joined here), else one process with no group.

    ``num_devices`` must equal the world size where it is given. ``--dp``
    (``cfg.dp`` False: the reference's switch that turns data parallelism
    off) raises at a world size above 1: a rank cannot be left idle.
    ``global_mixup`` needs ``bn_per_replica``."""
    if getattr(cfg, "global_mixup", False) and not getattr(
            cfg, "bn_per_replica", False):
        raise ValueError("--global-mixup requires --bn-per-replica (the "
                         "default sync-BN mode already mixes over the "
                         "global batch)")
    env = launcher_env()
    if dist.is_initialized():
        group = dist.group.WORLD
    elif env["world_size"] > 1:
        init_from_env(device)
        group = dist.group.WORLD
    else:
        group = None
    dp = DataParallel(group)
    want = getattr(cfg, "num_devices", None)
    if want is not None and want != dp.world_size:
        raise ValueError(f"--num-devices {want} but this run has "
                         f"{dp.world_size} rank(s); {_LAUNCH_HINT}")
    if not getattr(cfg, "dp", True) and dp.world_size > 1:
        raise ValueError("--dp turns data parallelism off, but this run has "
                         f"{dp.world_size} ranks; launch one process")
    return dp


def check_multihost(multihost: bool) -> None:
    """``--multihost`` (the JAX package's ``jax.distributed.initialize``)
    is the process group spanning hosts: it needs a launch over several
    hosts, and such a launch needs it."""
    env = launcher_env()
    multi_node = env["world_size"] > env["local_world_size"]
    if multihost and not multi_node:
        raise ValueError("--multihost needs a launch over several hosts: "
                         "torchrun --nnodes M --nproc-per-node N ...")
    if multi_node and not multihost:
        raise ValueError("this launch spans several hosts: pass --multihost")


def refuse_ranks(what: str) -> None:
    """Raise where a launcher started more than one rank for a trainer
    that runs on one card."""
    if launcher_env()["world_size"] > 1 or (
            dist.is_initialized() and dist.get_world_size() > 1):
        raise ValueError(f"{what} runs on one card, as in the JAX package; "
                         f"launch one process")


# ------------------------------------------------------- ranks on one host


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, port, args):
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo",
                timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one ``backend`` group on this host. Raises where any rank raises or
    exits badly (the others are stopped) or where the ranks outlast
    ``timeout_s``; stops every process it started."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(fn, world, backend,
                                               free_port(), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline
                                               - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
