"""The port's fused two-stream SHOT-VAE step (``fused_streams=True``)
against the JAX package's ``make_shot_vae_train_step(fused_streams=True)``.

One JAX VAE (WRN-10-1, Dc 8, K 10) with random BN affines and running
statistics is converted with the port's ``state_dict_from_jax`` and
strict-loaded into the port's model; augmentation is off. JAX's fused step
takes no ``inject``, so its draws are set from the test: while the jitted
step is traced, ``shotvae_tpu.ops.sampling.joint_latent`` is replaced by a
wrapper that hands each forward (A, then B) its ``noise`` from the step's
own inputs, and ``mixup.label_smoothing`` / ``mixup.mixup_vae_data`` by
wrappers that pass ``lam`` and ``index`` (the partners of the optimal
match are left to each side where it is on). The port gets the same arrays
through the four-forward step's ``inject`` keys; its labeled rows'
uniforms, which the labels' one-hots replace, are its own constant, while
JAX's are random, so a draw that leaked into the labeled rows would show.

Tolerances (f32): the loss, every metric, every parameter and running
statistic within 1e-3 (abs + rel) after each of 3 steps; each
parameter's update over the first step, from the same weights on both
sides (its gradient, scaled by the LR, plus its weight decay), within 0.1
of its largest element (max-norm, chip_smoke.py's TOL_GRAD_STEP: f32
rounding moves a gradient by up to a few 1e-2 where a LeakyReLU mask
flips, a wrong one is off by about 1), or within 1e-4 of the model's
largest update element (a conv bias before a BatchNorm has a gradient that
is rounding alone). After the first step the two sides' weights lie
rounding apart, the ReLU masks of the decoder flip apart, and a small
decoder update of the third step reads 0.16 of its size apart, so the
later steps' gradients are held through the parameters, as
test_torch_train.py holds the four-forward step's. One bf16 step within
3x the JAX bf16 fused step's own distance from the JAX f32 fused step
(test_torch_bf16_model.py's rule after a step), that distance the largest
over three seeded inputs (chip_smoke.py's BF16_CALIBRATION_DRAWS), and
the port's own bf16-vs-f32 distance within 0.25x to 4x of JAX's, the
median over the tensors of their ratio (a silent f32 step reads 0; the
largest distance is a reconstruction sum of about 2,000, whose rounding
one bf16 flip moves several-fold).
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import mixup as jax_mixup
from shotvae_tpu.ops import sampling as jax_sampling
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import make_shot_vae_train_step

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
STEPS = 3
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)
TOL = 1e-3
TOL_UPDATE = 0.1        # an update against JAX's, max-norm
UPDATE_FLOOR = 1e-4     # ... or of the model's largest update element
STEP_FACTOR = 3.0       # bf16: port vs JAX bf16 in units of JAX's bf16-f32
FLOOR = 1e-6            # bf16: relative to the tensor's largest value
OWN_RANGE = (0.25, 4.0)
SANITY = 0.05           # fused against four forwards, relative


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these tests use
    one intra-op thread."""
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
def models():
    """(JAX f32 model, JAX bf16 model, params, batch_stats)."""
    kw = dict(encoder_name=NET, continuous_latent_dim=DC, disc_latent_dim=K)
    jm32, jm16 = JaxVAE(**kw), JaxVAE(**kw, dtype=jnp.bfloat16)
    params, bs = jax_state.init_model(jm32, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    return jm32, jm16, params, bs


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_u": rng.integers(0, K, B).astype(np.int32)}


def _batch(data):
    return [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]


def _draws(rng, optimal_match: bool):
    """One step's draws under the four-forward step's keys (no ``perm_mx``
    where the optimal match picks the partners), and JAX's own uniforms
    for the labeled rows of forwards A and B."""
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    if not optimal_match:
        n["perm_mx"] = rng.permutation(B).astype(np.int32)
    jax_only = {f"unif_l_{f}": rng.random((B, K)).astype(np.float32)
                for f in "ab"}
    return n, jax_only


def _jax_fused_step(jm, optimal_match: bool):
    """JAX's fused step, jitted, as ``run(state, img_l, lab_l, img_u,
    lab_u, sched, key, draws)``: the draws enter as arguments and reach
    the step through the wrappers patched in while it is traced."""
    step = jax_steps.make_shot_vae_train_step(
        jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=optimal_match, fused_streams=True,
        aug=jax_steps.AugmentConfig(enabled=False))
    joint_latent = jax_sampling.joint_latent
    label_smoothing = jax_mixup.label_smoothing
    mixup_vae_data = jax_mixup.mixup_vae_data

    def run(state, img_l, lab_l, img_u, lab_u, sched, key, d):
        cat = jnp.concatenate
        noises = [{"eps": cat([d["eps_1"], d["eps_3"]]),
                   "unif": cat([d["unif_l_a"], d["unif_3"]])},
                  {"eps": cat([d["eps_2"], d["eps_4"]]),
                   "unif": cat([d["unif_l_b"], d["unif_4"]])}]

        def forward_noise(key, *args, noise=None, **kw):
            assert noise is None  # the fused step draws its own
            return joint_latent(key, *args, noise=noises.pop(0), **kw)

        def smoothing(key, *args, **kw):
            return label_smoothing(key, *args, lam=d["lam_sm"],
                                   index=d["perm_sm"], **kw)

        def posterior_mixup(key, *args, **kw):
            return mixup_vae_data(key, *args, lam=d["lam_mx"],
                                  index=d.get("perm_mx"), **kw)

        with contextlib.ExitStack() as patches:
            for module, name, fn in (
                    (jax_sampling, "joint_latent", forward_noise),
                    (jax_mixup, "label_smoothing", smoothing),
                    (jax_mixup, "mixup_vae_data", posterior_mixup)):
                patches.enter_context(mock.patch.object(module, name, fn))
            out = step(state, img_l, lab_l, img_u, lab_u, sched, key)
        assert not noises  # forwards A and B each took theirs
        return out

    return jax.jit(run)


def _jax_state(jm, params, bs):
    return jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
            0.1, [1], steps_per_epoch=1)))


def _port(params, bs, dtype=None, **step_kw):
    """The port's model, its TrainState and its fused step."""
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu", dtype=dtype)
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    kw = dict(num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
              optimal_match=True, aug=False, fused_streams=True)
    kw.update(step_kw)
    return pm, state, make_shot_vae_train_step(pm, opt, **kw)


def _jax_sd(jstate):
    return state_dict_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))


def _port_step(step, state, data, inject, seed=0):
    return step(state, *map(torch.from_numpy, _batch(data)), SCHED,
                torch.Generator().manual_seed(seed), inject=inject)


def _jax_step(run, jstate, data, inject, jax_only, seed=0):
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    return run(jstate, *map(jnp.asarray, _batch(data)), sched,
               jax.random.key(seed),
               {k: jnp.asarray(v) for k, v in {**inject, **jax_only}.items()})


def _hold_updates(got_after, got_before, want_after, want_before, what):
    """Each parameter's update within TOL_UPDATE of its largest element,
    max-norm, or within UPDATE_FLOOR of the model's largest."""
    keys = [k for k in want_after if not k.endswith("num_batches_tracked")
            and "running" not in k]
    want = {k: (want_after[k] - want_before[k]).double() for k in keys}
    largest = max(float(v.abs().max()) for v in want.values())
    for k in keys:
        got = (got_after[k] - got_before[k]).double()
        err = float((got - want[k]).abs().max())
        scale = float(want[k].abs().max())
        assert err <= max(TOL_UPDATE * scale, UPDATE_FLOOR * largest), (
            f"{what}: the update of {k} is {err:.3e} from JAX's (max-norm),"
            f" JAX's largest element {scale:.3e}")


@pytest.mark.parametrize("optimal_match", [False, True],
                         ids=["random_partners", "optimal_match"])
def test_fused_step_lockstep_matches_jax(models, data, optimal_match):
    """Three fused steps (LR warmup then a decay: 0.02, 0.1, 0.01) against
    JAX's fused step with the same draws: the loss and every metric, every
    parameter and running statistic, and every parameter's update over
    the first step."""
    jm, _, params, bs = models
    run = _jax_fused_step(jm, optimal_match)
    jstate = _jax_state(jm, params, bs)
    pm, state, step = _port(params, bs, optimal_match=optimal_match)
    rng = np.random.default_rng(2)
    for i in range(STEPS):
        inject, jax_only = _draws(rng, optimal_match)
        want_before = _jax_sd(jstate)
        got_before = {k: v.clone() for k, v in pm.state_dict().items()}
        jstate, want = _jax_step(run, jstate, data, inject, jax_only, i)
        got = _port_step(step, state, data, inject, i)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {i}: {k}")
        assert state.step == i + 1
        want_after = _jax_sd(jstate)
        got_after = pm.state_dict()
        assert set(got_after) == set(want_after)
        for k, w in want_after.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(
                    got_after[k].numpy(), w.numpy(), rtol=TOL, atol=TOL,
                    err_msg=f"after step {i}: {k}")
        if i == 0:
            _hold_updates(got_after, got_before, want_after, want_before,
                          "the first step")


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def _dist(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _seeded_data(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_u": rng.integers(0, K, B).astype(np.int32)}


def _jax_results(runs, params, bs, data, inject, jax_only) -> dict:
    """{tag: {name: tensor}} of one JAX fused step of each model of
    ``runs`` ({tag: (model, jitted run)}): its metrics and state dict."""
    out = {}
    for tag, (jm, run) in runs.items():
        jstate, metrics = _jax_step(run, _jax_state(jm, params, bs), data,
                                    inject, jax_only)
        out[tag] = {**{f"metric {k}": v for k, v in metrics.items()},
                    **_jax_sd(jstate)}
    return out


def test_fused_bf16_step_matches_jax_bf16(models, data):
    """One fused step of the bf16 model against JAX's fused step on its
    bf16 model: every metric, parameter and running statistic within
    STEP_FACTOR x the JAX bf16 fused step's distance from the JAX f32
    fused step, the largest over the step's inputs and two more seeded
    ones (chip_smoke.py's BF16_CALIBRATION_DRAWS: a scalar near 0, such
    as a discrete KL, lands far under its usual bf16 rounding on some
    inputs by chance)."""
    jm32, jm16, params, bs = models
    runs = {"jax32": (jm32, _jax_fused_step(jm32, True)),
            "jax16": (jm16, _jax_fused_step(jm16, True))}
    inject, jax_only = _draws(np.random.default_rng(3), True)
    res = _jax_results(runs, params, bs, data, inject, jax_only)
    keys = [k for k in res["jax16"] if not k.endswith("num_batches_tracked")]
    spread = {k: _dist(res["jax16"][k], res["jax32"][k]) for k in keys}
    for seed in (5, 6):
        more = _jax_results(runs, params, bs, _seeded_data(seed),
                            *_draws(np.random.default_rng(seed), True))
        spread = {k: max(v, _dist(more["jax16"][k], more["jax32"][k]))
                  for k, v in spread.items()}
    for tag, dtype in (("port32", None), ("port16", torch.bfloat16)):
        pm, state, step = _port(params, bs, dtype)
        metrics = _port_step(step, state, data, inject)
        res[tag] = {**{f"metric {k}": v for k, v in metrics.items()},
                    **pm.state_dict()}
    for k in keys:
        tol = max(FLOOR * (1.0 + float(np.abs(_np(res["jax16"][k])).max())),
                  STEP_FACTOR * spread[k])
        err = _dist(res["port16"][k], res["jax16"][k])
        assert err <= tol, (f"{k}: port bf16 {err:.3e} from JAX bf16, beyond"
                            f" {tol:.3e}")
    ratios = [_dist(res["port16"][k], res["port32"][k])
              / _dist(res["jax16"][k], res["jax32"][k]) for k in keys
              if _dist(res["jax16"][k], res["jax32"][k]) > 0]
    lo, hi = OWN_RANGE
    assert lo <= float(np.median(ratios)) <= hi, sorted(ratios)


def test_fused_refuses_global_mixup(models):
    """``fused_streams`` with ``global_mixup`` raises JAX's
    NotImplementedError, with JAX's message; ``global_mixup`` without the
    per-replica mode still raises its ValueError first, as in JAX."""
    jm, _, params, bs = models
    kw = dict(num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
              optimal_match=True, fused_streams=True, global_mixup=True)
    with pytest.raises(NotImplementedError) as want:
        jax_steps.make_shot_vae_train_step(jm, axis_name="batch", **kw)
    with pytest.raises(NotImplementedError) as got:
        _port(params, bs, bn_per_replica=True, global_mixup=True)
    assert str(got.value) == str(want.value) == (
        "global_mixup is only supported on the 4-forward path")
    with pytest.raises(ValueError, match="global_mixup requires"):
        jax_steps.make_shot_vae_train_step(jm, **kw)
    with pytest.raises(ValueError, match="global_mixup requires"):
        _port(params, bs, global_mixup=True)


def test_fused_step_is_close_to_four_forwards(models, data):
    """A sanity check, not a parity check: from the JAX model's own
    initialisation and on the same draws, the fused step's metrics lie
    within 5 % of the four-forward step's (the metrics JAX's own
    test_fused_streams_matches_4fwd_closely compares); they differ by the
    BN statistics pooled over 2B rows."""
    jm, _, _, _ = models
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    inject, _ = _draws(np.random.default_rng(4), False)
    out = {}
    for fused in (False, True):
        _, state, step = _port(jax.device_get(params), jax.device_get(bs),
                               fused_streams=fused, optimal_match=False)
        out[fused] = _port_step(step, state, data, inject)
    for k in ("recon_l", "recon_u", "cont_kl_l", "cont_kl_u",
              "kl_inference"):
        a, b = float(out[False][k]), float(out[True][k])
        assert abs(a - b) / max(abs(a), 1e-6) < SANITY, (k, a, b)
