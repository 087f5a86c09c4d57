"""``--steps-per-call`` N above 1 on the CPU: the chunk runner
(``shotvae_torch.train.chunk``, whose plain version runs the N deferred
steps one after another, reading the static inputs a graph replay reads)
against per-step dispatch and the JAX loop's chunked branch.

* One epoch of ``run_shot_vae``, ``run_shot_vae(m2=True)`` and
  ``run_classifier`` at N = 4 against N = 1 on 6 train steps (a chunk of 4
  that runs eagerly, then a chunk of 2 through the runner's static
  inputs), at the port's ``_tiny_cfg`` of tests/test_torch_loop.py
  (WRN-10-1, batch 32): every parameter, BN statistic and momentum buffer,
  the history and ``state.step``, bit for bit.
* The chunks' (n, batch) index stacks equal those of
  shotvae_tpu/train/loop.py:341-349 rebuilt from ``shotvae_tpu.data``.
* Three injected SHOT-VAE steps through the runner (a chunk of 2, a tail
  of 1; WRN-10-1, B = 8) against three JAX steps given the same
  ``inject``, at tests/test_torch_train.py's lockstep tolerances.
* A new ``sched``, rate and mixup weight written into the static inputs
  change the next chunk exactly as they change the eager steps.
* The pooled generators of ``StepDraws`` give the draws of fresh
  generators, and ``sgd_torch``'s fused update with its rate a tensor
  equals the same update with float rates bit for bit and
  ``torch.optim.SGD``'s foreach one within a last-ulp rounding.
* A ``--resume`` at N = 2 of the first epoch's checkpoint, as the port
  wrote it and as torch's default (foreach) SGD would have (its groups say
  ``fused: None``), equals the second epoch of a straight N = 2 run bit for
  bit, the run's fused SGD kept.

The epochs' TensorBoard writer is off (TensorBoard pulls in TensorFlow,
which costs more than the epochs; tests/test_torch_loop.py covers the
writer).

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotvae_tpu.data import pipeline as jax_pipeline
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.config import ClassifierConfig, ShotVaeConfig
from shotvae_torch.data.datasets import ArrayDataset
from shotvae_torch.data.pipeline import DeviceDataset
from shotvae_torch.io.checkpoint import IMPLEMENTATION_FLAGS
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.io.tb import TBWriter
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops import sampling
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train import loop
from shotvae_torch.train.chunk import LR, ChunkRunner
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import make_shot_vae_train_step
from torch_tpu_match import with_tpu_dense

N = 4
STEPS = 6          # 202 unlabeled images at batch 32: a chunk of 4 and of 2
NET, DC, K, B = "wideresnet-10-1", 8, 10, 8
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(base, kind: str, n: int):
    fields = dict(base_path=base, dataset="Cifar10", batch_size=32,
                  net_name=NET, ldc=8, synthetic_data=True,
                  synthetic_size=212, valid_per_class=1,
                  annotated_per_class=20 if kind == "classifier" else 10,
                  yes=True, epochs=1, reconstruct_freq=1, print_freq=100,
                  adjust_lr=[0, 1], bf16=False, ckpt_every=0,
                  steps_per_call=n)
    if kind == "classifier":
        return ClassifierConfig(**fields)
    return ShotVaeConfig(**fields)


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """One epoch of each loop at N = 1 and at N = 4."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "TBWriter",
                   lambda log_dir, enabled=True: TBWriter(log_dir, False))
        for kind in ("shot", "m2", "classifier"):
            for n in (1, N):
                cfg = _cfg(str(tmp_path_factory.mktemp(f"{kind}{n}")), kind,
                           n)
                run = (loop.run_classifier if kind == "classifier" else
                       lambda c, **kw: loop.run_shot_vae(
                           c, m2=kind == "m2", **kw))
                out[kind, n] = run(cfg, max_epochs=1, log_fn=lambda *a: None,
                                   device="cpu")
    return out


# two epochs of 3 steps at batch 16 in chunks of 2 (an eager chunk of 2,
# then a graph of 1), a checkpoint after each
RESUME_FIELDS = dict(batch_size=16, synthetic_size=60, ckpt_every=1,
                     epochs=2)


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    """Two epochs of ``run_shot_vae`` at N = 2 straight, then its second
    epoch again at N = 2 from the first epoch's checkpoint: as the port
    wrote it (``port``) and with its optimizer's groups carrying the
    implementation flags of torch's default foreach SGD
    (``foreign_sgd``)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "TBWriter",
                   lambda log_dir, enabled=True: TBWriter(log_dir, False))
        base = str(tmp_path_factory.mktemp("straight"))
        cfg = _cfg(base, "shot", 2)
        for k, v in RESUME_FIELDS.items():
            setattr(cfg, k, v)
        out["straight"] = loop.run_shot_vae(cfg, log_fn=lambda *a: None,
                                            device="cpu")
        first = torch.load(os.path.join(
            base, "Cifar10-SHOT-VAE", "parameter", "train_time_1",
            "checkpoint.slot0.pth.tar"), weights_only=True)
        assert first["epoch"] == 1
        foreign = torch.optim.SGD(torch.nn.Linear(2, 2).parameters(),
                                  lr=0.1, momentum=0.9, weight_decay=5e-4,
                                  foreach=True).param_groups[0]
        payloads = {"port": first, "foreign_sgd": copy.deepcopy(first)}
        for group in payloads["foreign_sgd"]["optimizer"]["param_groups"]:
            group.update({k: foreign[k] for k in IMPLEMENTATION_FLAGS
                          if k in foreign})
            assert group["fused"] is None
        for name, payload in payloads.items():
            path = str(tmp_path_factory.mktemp(name) / "epoch1.pth.tar")
            torch.save(payload, path)
            cfg = _cfg(base, "shot", 2)
            for k, v in RESUME_FIELDS.items():
                setattr(cfg, k, v)
            cfg.resume = path
            out[name] = loop.run_shot_vae(cfg, log_fn=lambda *a: None,
                                          device="cpu")
    return out


def _momentum(state) -> dict:
    return {i: s["momentum_buffer"]
            for i, s in state.optimizer.state_dict()["state"].items()}


def _state_equal(a, b) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ma, mb = _momentum(a), _momentum(b)
    assert list(ma) == list(mb) and len(ma) > 0
    for k in ma:
        assert torch.equal(ma[k], mb[k]), f"momentum {k}"
    assert a.step == b.step


@pytest.mark.parametrize("kind", ["shot", "m2", "classifier"])
def test_chunked_epoch_equals_per_step_dispatch(epochs, kind):
    """N = 4 against N = 1: parameters, BN statistics, momentum buffers,
    ``state.step`` and the history (but its seconds), bit for bit."""
    one, chunked = epochs[kind, 1], epochs[kind, N]
    _state_equal(chunked["state"], one["state"])
    assert chunked["state"].step == STEPS
    no_s = lambda h: [{k: v for k, v in e.items() if k != "seconds"}  # noqa
                      for e in h]
    assert no_s(chunked["history"]) == no_s(one["history"])
    if kind == "classifier":
        assert chunked["train_losses"] == one["train_losses"]


@pytest.mark.parametrize("checkpoint", ["port", "foreign_sgd"])
def test_resume_at_n2_equals_straight_run(resumes, checkpoint):
    """The second epoch at N = 2 resumed from the first epoch's checkpoint
    equals the straight run's second epoch bit for bit (parameters, BN
    statistics, momentum buffers, ``state.step``, history), also from a
    checkpoint of a foreign (foreach, ``fused: None``) SGD, whose flags
    the restore leaves out: the run's SGD stays fused."""
    straight, resumed = resumes["straight"], resumes[checkpoint]
    assert straight["state"].step == 2 * 3
    _state_equal(resumed["state"], straight["state"])
    no_s = lambda h: [{k: v for k, v in e.items() if k != "seconds"}  # noqa
                      for e in h]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert no_s(resumed["history"]) == no_s(straight["history"][1:])
    assert all(g["fused"] and g["foreach"] is None for g in
               resumed["state"].optimizer.param_groups)


def test_chunk_indices_equal_jax_chunked_branch():
    """The (n, batch) labeled and unlabeled index stacks of each chunk, and
    its first step, as the JAX loop's chunked branch builds them."""
    rng = np.random.default_rng(5)
    order = rng.permutation(400)
    labeled, unlabeled = order[:40], order[40:]
    seed, epoch, batch, spc = 3, 2, 32, 4
    labeled_iter = jax_pipeline.infinite_batches(
        np.random.default_rng([seed + 1, epoch]), labeled, batch)
    rng_u = np.random.default_rng([seed + 2, epoch])
    u_batches = list(jax_pipeline.epoch_batches(rng_u, unlabeled, batch))
    l_batches = [next(labeled_iter) for _ in u_batches]
    want = [(c0, np.stack(l_batches[c0:c0 + spc]),
             np.stack(u_batches[c0:c0 + spc]))
            for c0 in range(0, len(u_batches), spc)]
    got = list(loop.shot_vae_chunks(seed, epoch, labeled, unlabeled, batch,
                                    spc))
    assert [c0 for c0, _ in got] == [c0 for c0, _, _ in want] == [0, 4, 8]
    assert [len(idx) for _, idx in got] == [4, 4, 3]
    for (_, idx), (_, idx_l, idx_u) in zip(got, want):
        np.testing.assert_array_equal(idx[:, :batch], idx_l)
        np.testing.assert_array_equal(idx[:, batch:], idx_u)


# ----------------------------------------- the runner at B = 8, WRN-10-1


def _inject(rng):
    """One step's injected randomness (tests/test_torch_train.py's)."""
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    n["perm_mx"] = rng.permutation(B).astype(np.int32)
    return n


def _data():
    rng = np.random.default_rng(1)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "lab_u": rng.integers(0, K, B).astype(np.int32)}


def _runner(step, data, steps: int) -> ChunkRunner:
    """A runner over the (labeled | unlabeled) rows of ``data``, each step
    on index row arange(2B)."""
    ds = DeviceDataset(ArrayDataset(
        np.concatenate([data["img_l"], data["img_u"]]),
        np.concatenate([data["lab_l"], data["lab_u"]])), device="cpu")

    def step_by_index(state, idx, sched, draws, inject=None, shared=None):
        images, labels = ds.gather(idx)
        return step(state, images[:B], labels[:B], images[B:], labels[B:],
                    sched, draws, inject=inject, shared_generator=shared)

    return ChunkRunner(step_by_index, "cpu", steps=steps, width=2 * B)


def test_injected_chunk_matches_jax_steps():
    """Three SHOT-VAE steps through the runner, a chunk of 2 (eager) and a
    tail of 1 (the static inputs), every draw injected, the LR warm-up
    then a decay (0.02, 0.1, 0.01): each step's loss and metrics, then the
    parameters and running statistics after each chunk, against three
    JAX steps."""
    jm = JaxVAE(encoder_name=NET, continuous_latent_dim=DC, disc_latent_dim=K)
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
            0.1, [1], steps_per_epoch=1)))
    jstep = with_tpu_dense(jax.jit(jax_steps.make_shot_vae_train_step(
        jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=True, aug=jax_steps.AugmentConfig(enabled=False))))
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    step = make_shot_vae_train_step(pm, opt, num_classes=K, bce=True,
                                    x_sigma=1.0, epsilon=0.1,
                                    optimal_match=True, aug=False)
    data = _data()
    runner = _runner(step, data, 2)
    runner.set_sched(SCHED)
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    batch = [jnp.asarray(data[k]) for k in ("img_l", "lab_l", "img_u",
                                            "lab_u")]
    rng = np.random.default_rng(2)
    injects = [_inject(rng) for _ in range(3)]
    for c0, n in ((0, 2), (2, 1)):
        got = runner.run(state, np.tile(np.arange(2 * B), (n, 1)),
                         [(torch.Generator().manual_seed(c0 + j), None)
                          for j in range(n)], injects[c0:c0 + n])
        for j in range(n):
            jstate, want = jstep(jstate, *batch, sched,
                                 jax.random.key(c0 + j),
                                 {k: jnp.asarray(v)
                                  for k, v in injects[c0 + j].items()})
            assert set(runner.keys) == set(want)
            for k, g in zip(runner.keys, got[j]):
                np.testing.assert_allclose(float(g), float(want[k]),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {c0 + j}: {k}")
        assert state.step == c0 + n
        want_sd = state_dict_from_jax(jstate.params, jstate.batch_stats)
        for k, w in want_sd.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(
                    pm.state_dict()[k].numpy(), w.numpy(), rtol=1e-3,
                    atol=1e-3, err_msg=f"after step {c0 + n - 1}: {k}")
    assert list(runner.graphs) == [1]  # the tail: through static inputs


def _port_vae(seed: int):
    torch.manual_seed(seed)
    return VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                  disc_latent_dim=K, device="cpu")


def test_static_inputs_follow_new_values(monkeypatch):
    """After an eager chunk of 2, a new ``sched``, a new rate and a new
    mixup weight (every Beta draw 0.3) written into the runner's static
    inputs give the next chunk the parameters, statistics, momentum and
    metrics of two eager steps under the same values, bit for bit; the
    values stand in the static inputs."""
    data = _data()
    models = [_port_vae(0), None]
    models[1] = copy.deepcopy(models[0])
    states, steps = [], []
    for m in models:
        opt = sgd_torch(m)
        states.append(TrainState(m, opt, lambda s: 0.02))
        steps.append(make_shot_vae_train_step(
            m, opt, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
            optimal_match=False))
    runner = _runner(steps[0], data, 2)
    batch = [torch.from_numpy(data[k]) for k in ("img_l", "lab_l", "img_u",
                                                 "lab_u")]
    gens = lambda c0: [torch.Generator().manual_seed(c0 + j)  # noqa: E731
                       for j in range(2)]
    idx = np.tile(np.arange(2 * B), (2, 1))
    new_sched = {k: 2.0 * v + 0.01 for k, v in SCHED.items()}
    for c0, sched in ((0, SCHED), (2, new_sched)):
        if c0:
            for st in states:
                st.lr_schedule = lambda s: 0.07
            monkeypatch.setattr(
                sampling, "beta_value",
                lambda g, a, b: (sampling.draw_seed(g), 0.3)[1])
        runner.set_sched(sched)
        got = runner.run(states[0], idx, [(g, None) for g in gens(c0)])
        want = [steps[1](states[1], *batch, sched, g) for g in gens(c0)]
        for j in range(2):
            assert torch.equal(got[j], torch.stack(
                [want[j][k] for k in runner.keys])), f"step {c0 + j}"
    _state_equal(states[0], states[1])
    assert torch.equal(runner.scalars[:2, LR], torch.full((2,), 0.07))
    betas = [i for i, e in enumerate(runner.plan) if e[0] == "beta"]
    assert len(betas) == 2
    assert torch.equal(runner.scalars[:2, :2], torch.full((2, 2), 0.3))
    assert [float(v) for v in runner.sched.values()] == [
        float(np.float32(v)) for v in new_sched.values()]


def test_pooled_generators_draw_as_fresh_ones():
    """A ``StepDraws``' persistent generators, seeded from a host
    generator as the sites ask, draw what fresh ``device_generator``s
    seeded from the same host generator draw, step after step; its
    deferred slots re-seeded by ``seed`` draw the same again, and its
    weights are the host's Beta draws in float32."""
    pool = sampling.StepDraws("cpu")
    draws = lambda gs: [torch.randn(5, generator=gs[0]),  # noqa: E731
                        torch.randperm(7, generator=gs[1]),
                        torch.randint(0, 9, (4,), generator=gs[2])]
    for seed in (3, 4):
        host = torch.Generator().manual_seed(seed)
        fresh = [sampling.device_generator(host, "cpu") for _ in range(3)]
        want_lam = sampling.beta_value(host, 2.0, 2.0)
        want = draws(fresh)
        pool.draw(torch.Generator().manual_seed(seed))
        gens = [sampling.device_generator(pool, "cpu") for _ in range(3)]
        lam = pool.beta(2.0, 2.0)
        for g, w in zip(draws(gens), want):
            assert torch.equal(g, w)
        assert float(lam) == float(np.float32(want_lam))
        assert pool.generators == gens  # the same objects every step
        lams = pool.seed(torch.Generator().manual_seed(seed))
        pool.defer()
        again = [sampling.device_generator(pool, "cpu") for _ in range(3)]
        for g, w in zip(draws(again), want):
            assert torch.equal(g, w)
        assert lams == [want_lam]
    with pytest.raises(RuntimeError, match="deferred train step"):
        pool.defer().beta(2.0, 2.0)  # the plan asks for a generator first


def test_sgd_rate_tensor_against_torch_sgd():
    """``sgd_torch``'s fused SGD with its rate a 0-d tensor, as a chunk's
    steps give it, over five updates with rate changes: bit for bit equal
    to the same SGD given Python float rates (per-step dispatch), and
    within 1e-6 relative of ``torch.optim.SGD`` at its defaults (foreach:
    the last product may round differently); the state dict's layout is
    torch's."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 4))
    models = [model, copy.deepcopy(model), copy.deepcopy(model)]
    tensor_rate, float_rate = sgd_torch(models[0]), sgd_torch(models[1])
    ref = torch.optim.SGD(models[2].parameters(), lr=0.1, momentum=0.9,
                          weight_decay=5e-4)
    opts = (tensor_rate, float_rate, ref)
    assert tensor_rate.param_groups[0]["fused"]
    rate = torch.zeros(())
    x = torch.randn(32, 16)
    for lr in (0.02, 0.02, 0.1, 0.1, 0.01):
        for m, opt in zip(models, opts):
            opt.zero_grad()
            m(x).square().mean().backward()
        rate.fill_(lr)
        tensor_rate.param_groups[0]["lr"] = rate
        float_rate.param_groups[0]["lr"] = ref.param_groups[0]["lr"] = lr
        for opt in opts:
            opt.step()
        for p, q, r in zip(*(m.parameters() for m in models)):
            assert torch.equal(p, q)
            torch.testing.assert_close(p, r, rtol=1e-6, atol=1e-7)
    sd, want = tensor_rate.state_dict(), ref.state_dict()
    assert sd["state"].keys() == want["state"].keys()
    for k in sd["state"]:
        torch.testing.assert_close(sd["state"][k]["momentum_buffer"],
                                   want["state"][k]["momentum_buffer"],
                                   rtol=1e-5, atol=1e-7)
