"""The port's data parallelism (``shotvae_torch.parallel``) over two ranks
on the CPU, against the JAX package and against one process.

Two ranks over ``gloo``, started once for the whole file by
``spawn_ranks`` (each rank runs ``tests/torch_parallel_workers.py``, which
imports only the port), at the tiny shapes of the port's lockstep tests:
WRN-10-1, Dc 8, K 10, a global batch of 8 + 8 (4 + 4 a rank). The ranks'
results are held here against:

* one process on the whole batch: the sync-BN ``bn_leaky_train`` and
  ``fused_bn_act_conv_train`` (y, mean, var, dx, and dgamma / dbeta after
  the gradient mean); the sync-BN SHOT-VAE, M2 and classifier steps;
* JAX's ``make_shot_vae_train_step`` under
  ``DataParallel(make_mesh(2)).jit_step`` (the GSPMD sync-BN step) on the
  8-virtual-device CPU platform of tests/conftest.py, with the same
  injected draws and the optimal match left to the step (over the global
  batch);
* the per-replica step (``bn_per_replica``) against two local one-process
  steps on each rank's rows with its own draws (the gradient mean, rank
  0's or the mean running statistics), and against JAX's
  ``shard_map_step``;
* the fused two-stream step (``fused_streams``), sync-BN and per replica,
  against one process's fused steps;
* ``gather_mixup`` against one draw over the global batch on the host;
* a tiny two-rank ``run_shot_vae``: the same history on both ranks, files
  written by rank 0 only, a resume from rank 0's checkpoint equal to a
  straight run;
* ``--steps-per-call`` over the two ranks (the chunk runner's plain
  version): one tiny epoch of the sync-BN SHOT-VAE with ``--om``, the
  per-replica one with ``--global-mixup`` and the sync-BN classifier at
  N = 4 against N = 1 bit for bit; three injected SHOT-VAE steps through
  the runner against JAX's ``jit_step`` and ``shard_map_step``; the CLI
  at ``--steps-per-call 4`` inside the group; and, without ranks, the
  refusal of a gloo group on a CUDA device.

Tolerances: 1e-3 abs + rel on parameters, running statistics and metrics
(f32 goldens, as the port's lockstep tests hold the JAX step); one process
against two ranks differs only in the order of float32 sums, and is held
at 1e-4, and each gradient within 1e-2 of its largest element (max-norm,
as chip_smoke.py measures it): the ranks' statistics round apart from one
process's, so a pre-activation within rounding of 0 may take the other
LeakyReLU branch and move one element of the backward by its whole size
(about 1e-3 of conv0's weight gradient, at some seeded weights), where a
wrong sum (dgamma counted on every rank, a missing all-reduce) moves a
gradient by its own size. A gradient may also differ by ULP_FACTOR times
the one process's own spread when its weights move one ulp, or 1e-4 of
the model's largest gradient element, where that is larger (a conv bias
before a BatchNorm has a gradient that is rounding alone). Against JAX the gradients are held
through the parameters after the update, as the port's lockstep tests hold
them: at 4 rows a rank, the port's and JAX's decoder gradients already lie
up to 4e-2 apart (max-norm) in one process on the same rows, with the
parameters after the update within 1e-3.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import torch_parallel_workers as workers
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import mixup as jax_mixup
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.parallel import DataParallel as JaxDataParallel
from shotvae_tpu.parallel import make_mesh
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.parallel import spawn_ranks

WORLD = 2
B = 8             # global rows of each stream
LOCAL = B // WORLD
K, DC = workers.K, workers.DC
TOL = 1e-3        # against JAX
TOL_SPLIT = 1e-4  # against one process
TOL_GRAD_SPLIT = 1e-2  # a gradient against one process, max-norm
ULP_FACTOR = 3.0
LR0 = 0.02        # multistep_lr(0.1, [1], steps_per_epoch=1) at step 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ``--steps-per-call``: one tiny epoch of each case at N = CHUNK_N and at
# N = 1 on the two ranks, 6 steps at a global batch of 8 (a chunk of 4
# that runs eagerly, then a chunk of 2 through the runner's static inputs;
# the classifier's 43 labeled images give 6 steps too)
CHUNK_N = 4
_CHUNK_FIELDS = dict(dataset="Cifar10", batch_size=8,
                     net_name="wideresnet-10-1", ldc=8, synthetic_data=True,
                     synthetic_size=60, valid_per_class=1,
                     annotated_per_class=6, yes=True, epochs=1,
                     reconstruct_freq=1, print_freq=100, adjust_lr=[0, 1],
                     bf16=False, ckpt_every=0)
CHUNKED_CASES = {
    "shot_sync_om": ("shot", dict(_CHUNK_FIELDS, om=True)),
    "shot_replica_global_mixup": ("shot", dict(
        _CHUNK_FIELDS, bn_per_replica=True, global_mixup=True)),
    "classifier_sync": ("classifier", _CHUNK_FIELDS)}
CHUNK_STEPS = 6


def _randomize_bn(params, batch_stats, rng):
    draws = {"scale": lambda s: rng.uniform(0.8, 1.2, s),
             "bias": lambda s: rng.normal(0, 0.1, s),
             "mean": lambda s: rng.normal(0, 0.1, s),
             "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def perturb(tree):
        flat = traverse_util.flatten_dict(
            jax.tree_util.tree_map(np.asarray, tree))
        for path, v in flat.items():
            if "bn" in path:
                flat[path] = draws[path[-1]](v.shape).astype(np.float32)
        return traverse_util.unflatten_dict(flat)

    return perturb(params), perturb(batch_stats)


def _draws(rng, *, local_mixup=False):
    """One step's global injected draws. ``local_mixup``: each rank's own
    partners in its rows of ``perm_*`` and one weight a rank."""
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    if local_mixup:
        n["lam_sm"] = rng.beta(0.1, 0.1, WORLD).astype(np.float32)
        n["perm_sm"] = np.concatenate([rng.permutation(LOCAL)
                                       for _ in range(WORLD)]).astype(
                                           np.int64)
        n["lam_mx"] = rng.beta(2.0, 2.0, WORLD).astype(np.float32)
    else:
        n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
        n["perm_sm"] = rng.permutation(B).astype(np.int64)
        n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    return n


def _aug(rng, b):
    return (rng.integers(0, 9, b), rng.integers(0, 9, b),
            rng.random(b) < 0.5)


def _rank_view(job, r):
    """Rank ``r``'s one-process job: its rows and its own draws."""
    rows = slice(r * LOCAL, (r + 1) * LOCAL)
    inj = {}
    for k, v in job["inject"].items():
        if k.startswith("lam"):
            inj[k] = v[r]
        elif isinstance(v, tuple):
            inj[k] = tuple(a[rows] for a in v)
        else:
            inj[k] = v[rows]
    return dict(job, batch={k: v[rows] for k, v in job["batch"].items()},
                inject=inj, seed=job.get("seed", 0) + r)


@pytest.fixture(scope="module")
def setup():
    jm = JaxVAE(encoder_name=workers.NET, continuous_latent_dim=DC,
                disc_latent_dim=K)
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    rng = np.random.default_rng(5)
    batch = workers.numpy_batch(rng, B)
    sd = state_dict_from_jax(params, bs)
    sync = dict(kind="shot", state_dict=sd, batch=batch, aug=False,
                inject=_draws(rng))
    local = dict(kind="shot", state_dict=sd, batch=batch, aug=False,
                 inject=_draws(rng, local_mixup=True), bn_per_replica=True)
    rng_chunk = np.random.default_rng(7)
    torch.manual_seed(0)
    cls_model = workers.classifier()
    steps = {
        "shot_sync": sync,
        "shot_sync_aug": dict(sync, aug=True, inject=dict(
            sync["inject"], aug_l=_aug(rng, B), aug_u=_aug(rng, B))),
        "shot_replica0": dict(local, bn_stats="replica0"),
        "shot_mean": dict(local, bn_stats="mean"),
        "shot_global_mixup": dict(sync, bn_per_replica=True,
                                  global_mixup=True),
        "fused_sync": dict(sync, fused_streams=True),
        "fused_replica0": dict(local, bn_stats="replica0",
                               fused_streams=True),
        "m2_sync": dict(kind="m2", state_dict=sd, batch=batch, aug=True,
                        inject={"eps_1": sync["inject"]["eps_1"],
                                "eps_2": sync["inject"]["eps_2"],
                                "unif_2": sync["inject"]["unif_3"],
                                "aug_l": _aug(rng, B),
                                "aug_u": _aug(rng, B)}),
        "classifier_sync": dict(kind="classifier",
                                state_dict=cls_model.state_dict(),
                                batch={"img": batch["img_l"],
                                       "lab": batch["lab_l"]},
                                inject={"aug": _aug(rng, B)}),
    }
    g = torch.Generator().manual_seed(3)
    x4 = torch.randn((4 * B, 6, 6, 16), generator=g)
    parts = {
        "bn_sites": {
            "bn_leaky": {"x": torch.randn((4 * B, 16), generator=g) * 2 + 1,
                         "gamma": torch.rand(16, generator=g) + 0.5,
                         "beta": torch.randn(16, generator=g) * 0.1,
                         "g": torch.randn((4 * B, 16), generator=g)},
            "fused_conv": {
                "x": (x4 * 1.5 - 0.5).permute(0, 3, 1, 2),  # channels_last
                "gamma": torch.rand(16, generator=g) + 0.5,
                "beta": torch.randn(16, generator=g) * 0.1,
                "w": torch.randn((8, 16, 3, 3), generator=g) * 0.1,
                "g": torch.randn((4 * B, 6, 6, 8), generator=g).permute(
                    0, 3, 1, 2)}},
        "mixups": {"mixup": {
            "x": torch.randn((B, 8, 8, 3), generator=g),
            "mean": torch.randn((B, DC), generator=g),
            "ls": 0.1 * torch.randn((B, DC), generator=g),
            "la": torch.log_softmax(torch.randn((B, K), generator=g), 1),
            "lab": torch.randint(0, K, (B,), generator=g), "seed": 11}},
        # the misfits raise before anything runs; --steps-per-call 4 runs
        # one epoch of 6 steps at 4 + 4 a rank (a chunk of 4, then 2)
        "refusals": {"argv": ["-bp", "unused", "--synthetic-data", "--yes"],
                     "spc_argv": [
                         "--net-name", "wideresnet-10-1", "--ldc", "8",
                         "--synthetic-data", "--synthetic-size", "60", "-b",
                         "8", "--valid-per-class", "1",
                         "--annotated-per-class", "1", "--yes", "--no-bf16",
                         "--max-epochs", "1", "-p", "100", "-rf", "1",
                         "--ckpt-every", "0", "--steps-per-call", "4"]},
        "chunked": {"cases": CHUNKED_CASES, "n": CHUNK_N},
        "injected_chunk": {"steps": {
            "shot_sync": dict(sync, injects=[_draws(rng_chunk)
                                             for _ in range(3)]),
            "shot_replica0": dict(local, bn_stats="replica0", injects=[
                _draws(rng_chunk, local_mixup=True) for _ in range(3)])}},
        # 92 unlabeled images: one step of 32 + 32 a rank an epoch
        "epoch_and_resume": {"config": dict(
            dataset="Cifar10", batch_size=64, net_name="wideresnet-10-1",
            ldc=8, synthetic_data=True, synthetic_size=192,
            valid_per_class=10, annotated_per_class=10, yes=True, epochs=2,
            reconstruct_freq=1, print_freq=100, adjust_lr=[1, 500, 550],
            bf16=False, om=True)},
    }
    return dict(jax=(jm, params, bs), steps=steps, parts=parts)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Both ranks' outputs: {rank: results}."""
    folder = str(tmp_path_factory.mktemp("ranks"))
    torch.save({"steps": setup["steps"], "parts": setup["parts"]},
               os.path.join(folder, "jobs.pt"))
    spawn_ranks(workers.run, WORLD, folder, timeout_s=600)
    out = {}
    for r in range(WORLD):  # read, then removed: each is over 0.5 GB
        path = os.path.join(folder, f"rank{r}.pt")
        out[r] = torch.load(path, weights_only=False)
        os.remove(path)
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _normwise(got, want, tol, what, floor=0.0):
    """max |got - want| within ``tol`` x max |want| (chip_smoke.py's
    norm-wise error of a gradient), or within ``floor``."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= max(tol * scale, floor), \
        f"{what}: max |got - want| {err:.3e}, max |want| {scale:.3e}"


def _hold_step(got, want, tol, what, floor=None):
    """Metrics, parameters and running statistics within ``tol``; each
    gradient norm-wise within TOL_GRAD_SPLIT, or ``floor[k]``."""
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, tol, f"{what}: metric {k}")
    for k, v in want["state"].items():
        if not k.endswith("num_batches_tracked"):
            _close(got["state"][k], v, tol, f"{what}: {k}")
    for k, v in want["grads"].items():
        _normwise(got["grads"][k], v, TOL_GRAD_SPLIT,
                  f"{what}: gradient of {k}", (floor or {}).get(k, 0.0))


def _one_ulp_apart(state_dict):
    """``state_dict`` with every parameter moved one ulp up or down at
    random (seeded); the running statistics as they were."""
    g = torch.Generator().manual_seed(11)
    out = {}
    for k, v in state_dict.items():
        if v.is_floating_point() and "running" not in k:
            up = torch.rand(v.shape, generator=g) < 0.5
            v = torch.nextafter(v, torch.where(up, torch.tensor(np.inf),
                                               torch.tensor(-np.inf)))
        out[k] = v
    return out


def _one_process(job):
    """What the ranks of ``job`` must give, in one process: the step on
    the global batch (sync-BN), or two steps on each rank's rows with its
    own draws (per replica): the gradient mean, the running statistics of
    the policy, the metrics' mean, one SGD step along the mean gradient."""
    from shotvae_torch.train.state import TrainState, sgd_torch

    if not job.get("bn_per_replica") or job.get("global_mixup"):
        return workers.train_once(job)
    local = [workers.train_once(_rank_view(job, r)) for r in range(WORLD)]
    grads = {k: sum(lr["grads"][k] for lr in local) / WORLD
             for k in local[0]["grads"]}
    model = workers.vae(job["state_dict"])
    state = TrainState(model, sgd_torch(model), lambda step: LR0)
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    state.apply_gradients()
    sd = dict(model.state_dict())
    for k in sd:
        if "running" in k:
            runs = [lr["state"][k] for lr in local]
            sd[k] = runs[0] if job["bn_stats"] == "replica0" \
                else sum(runs) / WORLD
    return {"metrics": {k: sum(lr["metrics"][k] for lr in local) / WORLD
                        for k in local[0]["metrics"]},
            "state": sd, "grads": grads}


@pytest.fixture(scope="module")
def references(setup):
    """{step name: (one process's result, {parameter: the larger of
    ULP_FACTOR x the largest move of its gradient when the weights move one
    ulp, and TOL_SPLIT x the model's largest gradient element})}."""
    out = {}
    for name, job in setup["steps"].items():
        if name == "shot_global_mixup":
            continue  # a per-replica step with no one-process counterpart
        want = _one_process(job)
        ulp = _one_process(dict(job, state_dict=_one_ulp_apart(
            job["state_dict"])))
        largest = max(float(v.abs().max()) for v in want["grads"].values())
        out[name] = (want, {k: max(
            ULP_FACTOR * float((ulp["grads"][k] - v).double().abs().max()),
            TOL_SPLIT * largest) for k, v in want["grads"].items()})
    return out


def test_both_ranks_ran_and_agree(ranks):
    """Each rank knows its place, and after every step both hold the same
    parameters, buffers and metrics."""
    assert {r: ranks[r]["world"] for r in ranks} == {0: (0, 2), 1: (1, 2)}
    for name, res in ranks[0]["steps"].items():
        other = ranks[1]["steps"][name]
        assert res["metrics"] == other["metrics"], name
        for k, v in res["state"].items():
            assert torch.equal(v, other["state"][k]), f"{name}: {k}"


@pytest.mark.parametrize("site", ["bn_leaky", "fused_conv"])
def test_sync_bn_sites_match_one_process(setup, ranks, site):
    """The sync-BN plain versions on two halves against one process on
    the whole batch: y, the statistics and dx equal; dgamma and dbeta
    after the gradient mean over the ranks."""
    from shotvae_torch.ops.kernels.bn_leaky import bn_leaky_train
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv_train

    job = setup["parts"]["bn_sites"][site]
    x = job["x"].clone().requires_grad_(True)
    gamma = job["gamma"].clone().requires_grad_(True)
    beta = job["beta"].clone().requires_grad_(True)
    if site == "bn_leaky":
        y, mean, var = bn_leaky_train(x, gamma, beta)
    else:
        y, mean, var = fused_bn_act_conv_train(x, gamma, beta, job["w"])
    y.backward(job["g"])
    want = dict(y=y.detach(), mean=mean, var=var, dx=x.grad,
                dgamma=gamma.grad, dbeta=beta.grad)
    half = B * 2
    for r in range(WORLD):
        got = ranks[r]["bn_sites"][site]
        for k in ("mean", "var"):
            _close(got[k], want[k], TOL_SPLIT, f"{site} rank {r}: {k}")
        # each rank's loss is its rows' part of the one process's sum, so
        # the gradient mean over the ranks is the one process's over W
        for k in ("dgamma", "dbeta"):
            _close(got[k] * WORLD, want[k], TOL_SPLIT,
                   f"{site} rank {r}: {k}")
        for k in ("y", "dx"):
            _close(got[k], want[k][r * half:(r + 1) * half], TOL_SPLIT,
                   f"{site} rank {r}: {k}")


def _sched():
    return {k: jnp.float32(v) for k, v in workers.SCHED.items()}


def _jax_state(jm, params, bs):
    return jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
            0.1, [1], steps_per_epoch=1)))


def _jax_result(jm, new_state, metrics) -> dict:
    """JAX's metrics and state after the step (its gradients are held
    through the parameters)."""
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {},
            "state": state_dict_from_jax(jax.device_get(new_state.params),
                                         jax.device_get(
                                             new_state.batch_stats))}


@pytest.fixture(scope="module")
def jax_wrapped(setup):
    """(the two-device mesh's ``DataParallel``, ``get(replica, gm=False)``,
    the replicated initial state, whose optimizer is part of what a step
    compiles for): JAX's SHOT-VAE step (optimal match on, no crops) under ``jit_step``
    (sync-BN) or, with ``replica``, ``shard_map_step`` (per replica, with
    ``global_mixup`` as ``gm``), made once per form so that the tests that
    call one form share its compilation. While the module runs, JAX's
    mixup takes an injected weight of shape (1,) as a scalar
    (``_jax_lam_squeezed``: under ``shard_map`` a per-replica weight
    arrives as its replica's slice; a sync step's weight is 0-d)."""
    jm, params, bs = setup["jax"]
    jdp = JaxDataParallel(make_mesh(WORLD))
    made = {}

    def get(replica: bool, gm: bool = False):
        if (replica, gm) not in made:
            jstep = jax_steps.make_shot_vae_train_step(
                jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
                optimal_match=True,
                aug=jax_steps.AugmentConfig(enabled=False),
                **({"axis_name": jdp.axis_name, "global_mixup": gm}
                   if replica else {}))
            made[replica, gm] = (
                jdp.shard_map_step(jstep, batch_argnums=(0, 1, 2, 3, 6),
                                   donate_state=False) if replica else
                jdp.jit_step(jstep, batch_argnums=(0, 1, 2, 3),
                             donate_state=False))
        return made[replica, gm]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "mixup", _jax_lam_squeezed())
        yield jdp, get, jdp.replicate(_jax_state(jm, params, bs))


def test_sync_shot_step_matches_jax_gspmd(setup, ranks, jax_wrapped):
    """The two-rank sync-BN SHOT-VAE step (optimal match on, over the
    global batch) against JAX's step under ``jit_step`` on a two-device
    mesh, with the same injected draws."""
    jm, params, bs = setup["jax"]
    job = setup["steps"]["shot_sync"]
    _, get, state0 = jax_wrapped
    batch = [jnp.asarray(job["batch"][k])
             for k in ("img_l", "lab_l", "img_u", "lab_u")]
    new_state, metrics = get(False)(
        state0, *batch, _sched(),
        jax.random.key(0), {k: jnp.asarray(v)
                            for k, v in job["inject"].items()})
    want = _jax_result(jm, new_state, metrics)
    for r in range(WORLD):
        _hold_step(ranks[r]["steps"]["shot_sync"], want, TOL, f"rank {r}")


@pytest.mark.parametrize("name", ["shot_sync", "shot_sync_aug", "m2_sync",
                                  "classifier_sync"])
def test_sync_steps_match_one_process(ranks, references, name):
    """Each two-rank sync-BN step against the same step in one process on
    the global batch (the crops and flips replayed where ``aug``)."""
    want, spread = references[name]
    for r in range(WORLD):
        _hold_step(ranks[r]["steps"][name], want, TOL_SPLIT,
                   f"{name} rank {r}", spread)


@pytest.mark.parametrize("policy", ["replica0", "mean"])
def test_per_replica_step_matches_local_steps(ranks, references, policy):
    """The per-replica step: each rank's own statistics and mixup; its
    gradients are the mean of two one-process steps on each rank's rows
    with its own draws, its running statistics rank 0's (``replica0``) or
    their mean, its metrics their mean, and its parameters one SGD step
    along the mean gradient."""
    want, spread = references[f"shot_{policy}"]
    for r in range(WORLD):
        _hold_step(ranks[r]["steps"][f"shot_{policy}"], want, TOL_SPLIT,
                   f"{policy} rank {r}", spread)


@pytest.mark.parametrize("name", ["fused_sync", "fused_replica0"])
def test_fused_steps_match_one_process(ranks, references, name):
    """The fused two-stream step (``fused_streams``) in both data-parallel
    modes: sync-BN, whose statistics pool over the 2B rows of each forward
    on every rank, against one process's fused step on the global batch;
    per replica against two one-process fused steps on each rank's rows
    with its own draws (the gradient mean, rank 0's running statistics)."""
    want, spread = references[name]
    for r in range(WORLD):
        _hold_step(ranks[r]["steps"][name], want, TOL_SPLIT,
                   f"{name} rank {r}", spread)


def _jax_lam_squeezed():
    """JAX's mixup module with an injected weight of shape (1,) taken as a
    scalar: under ``shard_map`` a per-replica weight arrives as its
    replica's slice of a sharded (W,) array."""
    def squeeze(fn):
        def wrapped(*args, lam=None, **kw):
            if lam is not None and jnp.ndim(lam) == 1:
                lam = jnp.reshape(lam, ())
            return fn(*args, lam=lam, **kw)
        return wrapped

    return types.SimpleNamespace(
        **{**vars(jax_mixup),
           "label_smoothing": squeeze(jax_mixup.label_smoothing),
           "mixup_vae_data": squeeze(jax_mixup.mixup_vae_data)})


@pytest.mark.parametrize("name", ["shot_replica0", "shot_global_mixup"])
def test_per_replica_step_matches_jax_shard_map(setup, ranks, name,
                                                jax_wrapped):
    """The per-replica step against JAX's ``shard_map_step`` (replica 0's
    running statistics), every draw injected through the batch-sharded
    ``inject``: each replica's rows of the per-row draws, and for the
    mixup either each replica's own partners and weight (a mixup within
    the replica's rows) or, with ``global_mixup``, the global ones repeated
    once a replica."""
    jm, params, bs = setup["jax"]
    job = setup["steps"][name]
    gm = job.get("global_mixup", False)
    inj = dict(job["inject"])
    if gm:
        for k in ("perm_sm",):
            inj[k] = np.tile(inj[k], WORLD)
        for k in ("lam_sm", "lam_mx"):
            inj[k] = np.full(WORLD, inj[k], np.float32)
    _, get, state0 = jax_wrapped
    batch = [jnp.asarray(job["batch"][k])
             for k in ("img_l", "lab_l", "img_u", "lab_u")]
    new_state, metrics = get(True, gm)(
        state0, *batch, _sched(),
        jax.random.key(0), {k: jnp.asarray(v) for k, v in inj.items()})
    want = _jax_result(jm, new_state, metrics)
    for r in range(WORLD):
        _hold_step(ranks[r]["steps"][name], want, TOL, f"{name} rank {r}")


@pytest.mark.parametrize("name", ["label_smoothing", "mixup_vae_data",
                                  "optimal_match"])
def test_gather_mixup_matches_host_global_draw(setup, ranks, name):
    """Each rank's rows of ``gather_mixup`` equal the rows of one draw
    over the global batch on the host from the same generator: the
    partners exactly, the interpolations to the last ulp."""
    from shotvae_torch.ops import mixup

    job = setup["parts"]["mixups"]["mixup"]
    a = [job[k] for k in ("x", "mean", "ls", "la", "lab")]
    fn, arrays, kw = {
        "label_smoothing": (mixup.label_smoothing, a, {"epsilon": 0.1}),
        "mixup_vae_data": (mixup.mixup_vae_data, a[:4],
                           {"optimal_match": False}),
        "optimal_match": (mixup.mixup_vae_data, a[:4],
                          {"optimal_match": True})}[name]
    want = fn(*arrays, generator=torch.Generator().manual_seed(job["seed"]),
              **kw)
    for r in range(WORLD):
        got = ranks[r]["mixups"][name]
        rows = slice(r * LOCAL, (r + 1) * LOCAL)
        assert got.lam == want.lam
        if want.partner_labels is not None:
            assert torch.equal(got.partner_labels, want.partner_labels[rows])
        for k in ("image", "z_mean", "z_sigma", "disc_alpha"):
            torch.testing.assert_close(getattr(got, k),
                                       getattr(want, k)[rows], rtol=1e-6,
                                       atol=1e-7)


def _no_seconds(history):
    return [{k: v for k, v in h.items() if k != "seconds"} for h in history]


def test_two_rank_epoch_writes_on_rank0_and_resumes(ranks):
    """A tiny two-rank ``run_shot_vae``: both ranks log the same history;
    rank 0's base path holds the checkpoints and the TensorBoard run, rank
    1's holds nothing; the second epoch resumed on both ranks from rank
    0's checkpoint of the first leaves both with the same state."""
    r0, r1 = (ranks[r]["epoch_and_resume"] for r in range(WORLD))
    assert _no_seconds(r0["straight"]) == _no_seconds(r1["straight"])
    assert _no_seconds(r0["resumed"]) == _no_seconds(r1["resumed"])
    assert [h["epoch"] for h in r0["resumed"]] == [1]
    assert any(f.endswith("checkpoint.current") for f in r0["files"])
    assert any("events.out.tfevents" in f for f in r0["files"])
    assert r1["files"] == []
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert all(np.isfinite(h["train_loss"]) for h in r0["resumed"])


def test_two_rank_resume_equals_straight_run(ranks):
    """The resumed second epoch equals the second epoch of a straight
    two-epoch run bit for bit (parameters, buffers, history)."""
    r0 = ranks[0]["epoch_and_resume"]
    assert _no_seconds(r0["resumed"]) == _no_seconds(r0["straight"][1:])
    for k, v in r0["straight_state"].items():
        assert torch.equal(v, r0["state"][k]), k


def test_refusals_inside_a_group(ranks):
    """Inside a two-rank group, ``--dp`` (data parallelism off) and a
    ``--num-devices`` other than the world size raise before anything
    runs; ``--steps-per-call 4`` runs: one CLI epoch of 6 steps on both
    ranks, with the same history on each."""
    for r in range(WORLD):
        out = ranks[r]["refusals"]
        assert "--dp turns data parallelism off" in out["dp"]
        assert "--num-devices 3 but this run has 2 rank(s)" in \
            out["num_devices"]
        (h,) = out["steps_per_call"]
        assert h["epoch"] == 0 and np.isfinite(h["train_loss"])
        assert 0.0 <= h["valid_top1"] <= 1.0
    assert _no_seconds(ranks[0]["refusals"]["steps_per_call"]) == \
        _no_seconds(ranks[1]["refusals"]["steps_per_call"])


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_epoch_over_two_ranks_equals_per_step(ranks, case):
    """``--steps-per-call 4`` over the two gloo ranks (the runner's plain
    version) against per-step dispatch over the same ranks: on each rank
    every parameter, BN statistic and momentum buffer bit for bit
    (compared on the rank), ``state.step``, the history and the
    collectives the steps issued as many; both ranks' final states
    alike (their digests)."""
    for r in range(WORLD):
        res = ranks[r]["chunked"][case]
        assert res["differ"] == [], f"rank {r}: {res['differ'][:5]}"
        assert res["tensors"] > res["momenta"] > 0
        assert res["step"] == {1: CHUNK_STEPS, CHUNK_N: CHUNK_STEPS}
        assert res["history"][CHUNK_N] == res["history"][1]
        assert res["collectives"][CHUNK_N] == res["collectives"][1] > 0
    assert ranks[0]["chunked"][case]["digest"] == \
        ranks[1]["chunked"][case]["digest"]


@pytest.mark.parametrize("name", ["shot_sync", "shot_replica0"])
def test_injected_chunk_over_two_ranks_matches_jax(setup, ranks, name,
                                                   jax_wrapped):
    """Three SHOT-VAE steps through the chunk runner on the two ranks (a
    chunk of 2, then a tail of 1 through the static inputs), every draw
    injected, the LR warm-up then a decay (0.02, 0.1, 0.01), against three
    JAX steps under ``jit_step`` (sync-BN) or ``shard_map_step`` (per
    replica, replica 0's statistics) on a two-device mesh with the same
    ``inject``: each step's metrics, then the parameters and running
    statistics after each chunk, at the file's JAX tolerance."""
    jm, params, bs = setup["jax"]
    job = setup["parts"]["injected_chunk"]["steps"][name]
    jdp, get, jstate = jax_wrapped
    wrapped = get(job.get("bn_per_replica", False))
    batch = [jnp.asarray(job["batch"][k])
             for k in ("img_l", "lab_l", "img_u", "lab_u")]
    want = []
    for i, inj in enumerate(job["injects"]):
        # replicated as the first call's state was: one compilation
        jstate, metrics = wrapped(jdp.replicate(jstate), *batch, _sched(),
                                  jax.random.key(i),
                                  {k: jnp.asarray(v) for k, v in inj.items()})
        want.append(_jax_result(jm, jstate, metrics))
    for r in range(WORLD):
        got = ranks[r]["injected_chunk"][name]
        assert got["step"] == 3 and got["graphs"] == [1]
        for i, w in enumerate(want):
            assert got["metrics"][i].keys() == w["metrics"].keys()
            for k, v in w["metrics"].items():
                _close(got["metrics"][i][k], v, TOL,
                       f"{name} rank {r} step {i}: {k}")
        for state, i in zip(got["states"], (1, 2)):
            for k, v in want[i]["state"].items():
                if not k.endswith("num_batches_tracked"):
                    _close(state[k], v, TOL,
                           f"{name} rank {r} after step {i}: {k}")


def test_gloo_group_on_a_card_refuses_steps_per_call():
    """A chunk runner over a gloo group on a CUDA device raises a
    ``ValueError`` naming NCCL before it touches the card (gloo stages a
    CUDA tensor through the host, which a graph cannot capture); a gloo
    group on the CPU, an NCCL group on a card and no group pass the
    check."""
    from shotvae_torch.train.chunk import ChunkRunner, check_capturable

    group = lambda backend: types.SimpleNamespace(  # noqa: E731
        group=object(), backend=backend, world_size=WORLD)
    with pytest.raises(ValueError, match="NCCL"):
        ChunkRunner(lambda *a, **kw: None, "cuda", steps=4, width=2 * B,
                    dp=group("gloo"))
    with pytest.raises(ValueError, match="gloo group on a CUDA card"):
        check_capturable(group("gloo"), torch.device("cuda", 0))
    check_capturable(group("gloo"), "cpu")
    check_capturable(group("nccl"), "cuda")
    check_capturable(None, "cuda")


def test_nccl_blocking_wait_refuses_steps_per_call(monkeypatch):
    """With ``TORCH_NCCL_BLOCKING_WAIT`` set, an NCCL group on a CUDA
    device refuses a chunk runner (each collective would wait on the host
    inside a capture); unset, or on the CPU, it passes."""
    from shotvae_torch.train.chunk import ChunkRunner, check_capturable

    nccl = types.SimpleNamespace(group=object(), backend="nccl",
                                 world_size=WORLD)
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "1")
    with pytest.raises(ValueError, match="TORCH_NCCL_BLOCKING_WAIT"):
        ChunkRunner(lambda *a, **kw: None, "cuda", steps=4, width=2 * B,
                    dp=nccl)
    check_capturable(nccl, "cpu")
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "0")
    check_capturable(nccl, "cuda")


@pytest.mark.parametrize("flags,match", [
    (["--num-devices", "2"], "torchrun --nproc-per-node N"),
    (["--global-mixup"], "requires --bn-per-replica"),
    (["--multihost"], "launch over several hosts")])
def test_cli_refusals_without_a_launcher(flags, match, tmp_path):
    """Without torchrun: more than one device, ``--global-mixup`` without
    ``--bn-per-replica`` and ``--multihost`` raise and write nothing."""
    from shotvae_torch.cli.main_shot_vae import main

    with pytest.raises(ValueError, match=match):
        main(["-bp", str(tmp_path), "--synthetic-data", "--yes", *flags],
             device="cpu")
    assert not os.listdir(tmp_path)


def test_a_failing_rank_fails_the_run(tmp_path):
    """``spawn_ranks`` raises where one rank raises, and stops the rest."""
    torch.save({"fail_on_rank": 1}, tmp_path / "jobs.pt")
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(workers.run, WORLD, str(tmp_path), timeout_s=120)
