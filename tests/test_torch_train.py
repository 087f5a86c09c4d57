"""The port's train-mode VAE, SHOT-VAE train step and eval step against the
JAX package.

One JAX VAE (WRN-10-1, Dc 8, K 10) with random BN affines and running
statistics is converted with the port's ``state_dict_from_jax`` and
strict-loaded into the port's model. Both sides get the same numpy images,
labels and injected draws; on the CPU the port's kernel wrappers run their
plain versions.

Tolerances (f32 throughout, both sides on the CPU's convolutions):
* train-mode forward: 1e-4 on the heads and the running statistics, 1e-3
  on the decoder logits (its five BN sites and 1024-channel sums);
* train step, 3 steps in lockstep: 1e-4 relative on the loss and every
  metric, 1e-3 on every parameter and running statistic after each step.
  The gradients are checked through the parameters, which after a step are
  p - lr * (momentum buffer of grad + wd * p);
* eval step: 1e-4 relative on the weighted sums, 1e-4 on the
  reconstruction.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import (make_shot_vae_train_step,
                                       make_vae_eval_step)
from torch_tpu_match import with_tpu_dense

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
STEPS = 3
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once, and the port's
    many small CPU ops slow down many times over when every process also
    runs a pool of intra-op threads; these tests use one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(params, batch_stats, rng):
    """Random BN affines and running statistics."""
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


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxVAE(encoder_name=NET, continuous_latent_dim=DC, disc_latent_dim=K)
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    return jm, params, bs


def _port_model(params, bs):
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    return pm


def _compare_state(pm, params, bs, tol, what):
    want = state_dict_from_jax(params, bs)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "lab_u": rng.integers(0, K, B).astype(np.int32),
            "eps": rng.normal(size=(B, DC)).astype(np.float32),
            "unif": rng.uniform(size=(B, K)).astype(np.float32)}


def _x(img):
    return img.astype(np.float32) / 255.0


@pytest.mark.parametrize("case", ["unlabeled", "labels", "mixup"])
def test_train_forward_and_running_stats_match_jax(jax_model, data, case):
    """One train-mode forward: outputs, and every running statistic after
    it, against ``model.apply(train=True, mutable=["batch_stats"])``."""
    jm, params, bs = jax_model
    labels = data["lab_l"].copy()
    labels[::3] = -1   # rows that keep the Gumbel draw
    kw = {"unlabeled": {},
          "labels": {"labels": labels},
          "mixup": {"labels": labels, "mixup": True,
                    "labels_mixup": np.roll(data["lab_l"], 1),
                    "mixup_lam": 0.3}}[case]
    noise = {"eps": data["eps"], "unif": data["unif"]}
    x = _x(data["img_u"])
    want, updates = with_tpu_dense(jm.apply)(
        {"params": params, "batch_stats": bs}, jnp.asarray(x), train=True,
        noise={k: jnp.asarray(v) for k, v in noise.items()},
        rngs={"sample": jax.random.key(0), "dropout": jax.random.key(1)},
        mutable=["batch_stats"],
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    pm = _port_model(params, bs).train()
    got = pm(torch.from_numpy(x).permute(0, 3, 1, 2),
             noise={k: torch.from_numpy(v) for k, v in noise.items()},
             **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()})
    np.testing.assert_allclose(got[0].detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), rtol=1e-3, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    _compare_state(pm, params, updates["batch_stats"], 1e-4, case)


def _draws(rng):
    """One step's injected randomness, as numpy, for both sides."""
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    n["perm_mx"] = rng.permutation(B).astype(np.int32)
    return n


def test_train_step_lockstep_matches_jax(jax_model, data):
    """Three SHOT-VAE steps (bce, optimal match, augmentation off, every
    draw injected; LR warmup then a decay: 0.02, 0.1, 0.01): loss, metrics,
    parameters and running statistics after every step."""
    jm, params, bs = jax_model
    jax_lr = jax_schedules.multistep_lr(0.1, [1], steps_per_epoch=1)
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_lr))
    jstep = with_tpu_dense(jax.jit(jax_steps.make_shot_vae_train_step(
        jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=True, aug=jax_steps.AugmentConfig(enabled=False))))
    pm = _port_model(params, bs)
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    step = make_shot_vae_train_step(
        pm, opt, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=True, aug=False)
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    rng = np.random.default_rng(2)
    batch = [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]
    for i in range(STEPS):
        n = _draws(rng)
        jstate, want = jstep(jstate, *map(jnp.asarray, batch), sched,
                             jax.random.key(i),
                             {k: jnp.asarray(v) for k, v in n.items()})
        got = step(state, *map(torch.from_numpy, batch), SCHED,
                   torch.Generator().manual_seed(i), inject=n)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        assert state.step == i + 1
        _compare_state(pm, jstate.params, jstate.batch_stats, 1e-3,
                       f"after step {i}")


def test_train_step_draws_and_augments(jax_model, data):
    """With nothing injected: the step draws from its generator (one seed
    one step), augments, and moves every parameter."""
    _, params, bs = jax_model
    batch = [torch.from_numpy(data[k]) for k in ("img_l", "lab_l", "img_u",
                                                 "lab_u")]
    out = []
    for _ in range(2):
        pm = _port_model(params, bs)
        opt = sgd_torch(pm, lr=0.05)
        state = TrainState(pm, opt)
        step = make_shot_vae_train_step(pm, opt, num_classes=K, bce=True,
                                        x_sigma=1.0, epsilon=0.1,
                                        optimal_match=True)
        metrics = step(state, *batch, SCHED, torch.Generator().manual_seed(5))
        out.append((metrics, copy.deepcopy(pm.state_dict())))
    (m1, s1), (m2, s2) = out
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    before = _port_model(params, bs).state_dict()
    moved = [k for k in before if k.endswith("weight")
             and not torch.equal(before[k], s1[k])]
    assert len(moved) == sum(k.endswith("weight") for k in before)


def test_eval_step_matches_jax_with_a_mask(jax_model, data):
    """The eval step's weighted sums and reconstruction against
    ``make_vae_eval_step`` on a batch whose mask has zeros."""
    jm, params, bs = jax_model
    weight = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    inject = {"eps": data["eps"], "unif": data["unif"]}
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=params,
                                         batch_stats=bs,
                                         tx=jax_state.sgd_torch(0.1))
    jstep = with_tpu_dense(jax_steps.make_vae_eval_step(
        jm, num_classes=K, bce=True, x_sigma=1.0))
    want, want_recon = jstep(jstate, jnp.asarray(data["img_u"]),
                             jnp.asarray(data["lab_u"]), jnp.asarray(weight),
                             jax.random.key(0),
                             {k: jnp.asarray(v) for k, v in inject.items()})
    step = make_vae_eval_step(_port_model(params, bs), num_classes=K,
                              bce=True, x_sigma=1.0)
    got, recon = step(torch.from_numpy(data["img_u"]),
                      torch.from_numpy(data["lab_u"]),
                      torch.from_numpy(weight),
                      inject={k: torch.from_numpy(v)
                              for k, v in inject.items()})
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(got["count"]) == 5.0
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon),
                               rtol=1e-4, atol=1e-4)
