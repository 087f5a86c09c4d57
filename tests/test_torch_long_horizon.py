"""The port's SHOT-VAE and M2 train steps in lockstep with the JAX steps for
150 steps on the CPU, with the JAX draws injected: the CPU half of "does
the port learn".

The 3-step lockstep tests (test_torch_train.py, test_torch_m2.py) pin the
composed step; they leave the divergence over hundreds of steps unbounded.
Here, as tests/test_lockstep_long_horizon.py runs JAX against the
reference, the torch side builds its WRN-10-1 VAE (Dc 8, K 10, f32) from a
seed with its own init and JAX imports those weights
(``import_torch_state_dict``); both train at the production optimizer
(SGD, lr 0.1, momentum 0.9, wd 5e-4) with a fresh seeded batch of 8 (+ 8)
images every step, every draw injected (the SHOT step's latent noise,
Gumbel uniforms, mixup weights and partners; M2's latent noise and
uniforms), the augmentation off.

The bounds are that file's. The two sides' convolutions round differently
(XLA's CPU backend and torch's), and at lr 0.1 with momentum the
trajectories separate as a chaotic optimizer's do and saturate; a wrong
term, weight or BN order instead keeps compounding and shows in the
per-step loss from the start. So, at lr 0.1: the parameters' relative L2
distance under 0.2 at step 150 and under twice its step-75 and step-100
values (no late acceleration), the BN running statistics' under 0.7, and
every step's loss within 2e-2 relative. A low-lr control arm (lr 1e-3, 40
steps) must sit under 5e-3 with losses within 2e-3: rounding noise
amplified through the update path comes down with the step size, a
systematic difference would not. How close the chaos runs to the loss
bound: over the same 150 M2 steps from JAX's own init, JAX against itself
with its initial weights moved by one ulp differed by up to 1.28e-2 in a
step's loss (steps 41 to 59, while the weights separate), the port
against itself by 1.91e-2, and the port against JAX by 2.17e-2; from the
port's init, as here, 1.44e-2.

Each JAX step is compiled once in this file: its learning rate is an
injected hyperparameter of the same SGD (``optax.inject_hyperparams``), so
the control arm reuses the compiled step.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shotvae_tpu.io.torch_compat import (import_torch_state_dict,
                                         merge_imported)
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import (make_m2_train_step,
                                       make_shot_vae_train_step)
from torch_tpu_match import with_tpu_dense

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
T = 0.67
LR, MOM, WD = 0.1, 0.9, 5e-4
LOW_LR = 1e-3
DRIFT_STEPS, CONTROL_STEPS = 150, 40
LOG_EVERY = 25
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tx():
    """sgd_torch(lr) with the rate as an injected hyperparameter: one
    compiled step for every rate."""
    return optax.chain(
        optax.add_decayed_weights(WD),
        optax.inject_hyperparams(optax.sgd)(learning_rate=LR,
                                            momentum=MOM))


@pytest.fixture(scope="module")
def jax_side():
    """(model, template params, template batch_stats, {kind: jitted
    step})."""
    jm = JaxVAE(encoder_name=NET, continuous_latent_dim=DC,
                disc_latent_dim=K, sample_temperature=T)
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    off = jax_steps.AugmentConfig(enabled=False)
    steps = {
        "shot": with_tpu_dense(jax.jit(jax_steps.make_shot_vae_train_step(
            jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
            optimal_match=False, aug=off))),
        "m2": with_tpu_dense(jax.jit(jax_steps.make_m2_train_step(
            jm, num_classes=K, bce=True, x_sigma=1.0, aug=off)))}
    return jm, params, bs, steps


def _draws(rng, kind):
    """One step's injected randomness, as numpy, for both sides."""
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 3 if kind == "m2" else 5)}
    if kind == "m2":
        n["unif_2"] = rng.random((B, K)).astype(np.float32)
        return n
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    n["perm_mx"] = rng.permutation(B).astype(np.int32)
    return n


def _batch(rng):
    return (rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, K, B).astype(np.int32),
            rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, K, B).astype(np.int32))


def _rel_l2(pm, params, bs):
    """The parameters' and the running statistics' relative L2 distance,
    ||port - JAX|| / ||JAX||, each over its whole set."""
    want = state_dict_from_jax(params, bs)
    got = pm.state_dict()
    out = []
    for stats in (False, True):
        keys = [k for k in want if not k.endswith("num_batches_tracked")
                and k.endswith(("running_mean", "running_var")) == stats]
        g = torch.cat([got[k].reshape(-1).double() for k in keys])
        w = torch.cat([want[k].reshape(-1).double() for k in keys])
        out.append(float(torch.linalg.norm(g - w)
                         / (torch.linalg.norm(w) + 1e-12)))
    return tuple(out)


def _run(jax_side, kind, lr, steps, seed, data_seed):
    """``steps`` steps of both sides at ``lr`` from the port's init at
    ``seed``; (curve, worst loss relative difference), the curve holding
    (step, param relL2, stat relL2, loss relative difference) at step 1,
    every LOG_EVERY and the last."""
    jm, template, template_bs, jsteps = jax_side
    torch.manual_seed(seed)
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, sample_temperature=T,
                                device="cpu")
    params, bs = merge_imported(template, template_bs,
                                *import_torch_state_dict(pm.state_dict(),
                                                         "vae"))
    assert _rel_l2(pm, params, bs) == (0.0, 0.0)  # one start
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=params,
                                         batch_stats=bs, tx=_tx())
    jstate.opt_state[1].hyperparams["learning_rate"] = jnp.float32(lr)
    opt = sgd_torch(pm, lr=lr, momentum=MOM, weight_decay=WD)
    state = TrainState(pm, opt)
    make = make_m2_train_step if kind == "m2" else make_shot_vae_train_step
    extra = {} if kind == "m2" else dict(epsilon=0.1, optimal_match=False)
    step = make(pm, opt, num_classes=K, bce=True, x_sigma=1.0, aug=False,
                **extra)
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    rng = np.random.default_rng(data_seed)
    curve, worst = [], 0.0
    for i in range(steps):
        batch = _batch(rng)
        n = _draws(rng, kind)
        jstate, want = jsteps[kind](
            jstate, *map(jnp.asarray, batch), sched, jax.random.key(i),
            {k: jnp.asarray(v) for k, v in n.items()})
        got = step(state, *map(torch.from_numpy, batch), SCHED,
                   torch.Generator().manual_seed(i), inject=n)
        ours, theirs = float(got["loss"]), float(want["loss"])
        assert np.isfinite(ours) and np.isfinite(theirs), f"step {i + 1}"
        rel = abs(ours - theirs) / (abs(theirs) + 1e-12)
        worst = max(worst, rel)
        if i == 0 or (i + 1) % LOG_EVERY == 0 or i + 1 == steps:
            rp, rs = _rel_l2(pm, jstate.params, jstate.batch_stats)
            curve.append((i + 1, rp, rs, rel))
            print(f"{kind} lr={lr} step {i + 1:3d}: param relL2={rp:.3e} "
                  f"stat relL2={rs:.3e} loss rel={rel:.3e}")
    return curve, worst


# the model and data seeds of tests/test_lockstep_long_horizon.py: the
# SHOT-VAE step's here, the M2 step's in test_torch_long_horizon_m2.py
# (its own file, so that the two arms run on two workers)
SEEDS = [("shot", 51, 52)]


def check_drift(curve, worst) -> None:
    """The lr-0.1 arm's bounds (the module docstring)."""
    at = {s: p for s, p, *_ in curve}
    final_step, final_rp, final_rs, _ = curve[-1]
    assert final_step == DRIFT_STEPS
    assert final_rp < 0.2, f"param divergence {final_rp} at 150 steps"
    assert final_rs < 0.7, f"BN stat divergence {final_rs} at 150 steps"
    assert worst < 2e-2, f"worst per-step loss relative difference {worst}"
    for mid in (75, 100):
        assert final_rp < 2 * max(at[mid], 1e-6), (
            f"param divergence accelerating: {at[mid]} at {mid} -> "
            f"{final_rp} at 150")


def check_control(curve, worst) -> None:
    """The low-lr control arm's bounds."""
    final_rp = curve[-1][1]
    assert final_rp < 5e-3, (
        f"low-lr param divergence {final_rp}: not rounding noise; check "
        "the step's composition")
    assert worst < 2e-3, f"low-lr loss relative difference {worst}"


@pytest.mark.parametrize("kind,seed,data_seed", SEEDS)
def test_150_steps_in_lockstep_with_jax(jax_side, kind, seed, data_seed):
    check_drift(*_run(jax_side, kind, LR, DRIFT_STEPS, seed, data_seed))


@pytest.mark.parametrize("kind,seed,data_seed", SEEDS)
def test_low_lr_control_arm(jax_side, kind, seed, data_seed):
    check_control(*_run(jax_side, kind, LOW_LR, CONTROL_STEPS, seed,
                        data_seed))
