"""The port's M2 baseline against the JAX package: its train step in a
3-step lockstep with ``make_m2_train_step`` (f32), one bf16 step at the
calibrated bound, and one tiny epoch of ``run_shot_vae(m2=True)`` on the
CPU (its run folders, its ``cmi`` and no ``ewm`` bump).

One JAX VAE (WRN-10-1, Dc 8, K 10) with random BN affines and running
statistics is converted with the port's ``state_dict_from_jax`` and
strict-loaded into the port's model. Both sides get the same numpy images,
labels and injected draws (``eps_1``, ``eps_2``, ``unif_2``); the crops and
flips are those the JAX step draws from its key, replayed in the port as
``aug_l`` / ``aug_u``. On the CPU the port's kernel wrappers run their
plain versions.

Tolerances: the f32 lockstep holds the loss and every metric within 1e-4
relative, every parameter and running statistic within 1e-3 after each
step (as the SHOT-VAE lockstep in test_torch_train.py). The bf16 step is
held within max(a floor of 1e-6 of the tensor's largest value, 3x the JAX
bf16 step's own distance from the JAX f32 step), the bound of
test_torch_bf16_model.py, with JAX's distance taken as its largest over
three draws; and the port's own bf16-vs-f32 distance within 0.25x to 4x of
JAX's.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from shotvae_tpu import config as jax_config
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.config import ShotVaeConfig
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train.loop import run_shot_vae
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import make_m2_train_step
from torch_tpu_match import with_tpu_dense

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
STEPS = 3
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)
M2_METRICS = ["loss", "loss_supervised", "loss_unsupervised", "recon_l",
              "cont_kl_l", "disc_kl_l", "recon_u", "cont_kl_u", "disc_kl_u",
              "kl_inference"]  # shotvae_tpu/train/steps.py:446-453
STEP_FACTOR = 3.0     # port vs JAX bf16, in units of JAX's bf16-vs-f32
FLOOR = 1e-6          # relative to the tensor's largest value
OWN_RANGE = (0.25, 4.0)
CALIBRATION_DRAWS = 3  # JAX steps whose bf16-vs-f32 distance sets the scale


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
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "lab_u": rng.integers(0, K, B).astype(np.int32)}


def _port(params, bs, dtype=None):
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu", dtype=dtype)
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    return pm


def _jax_offsets(key, b):
    """The crops and flips shotvae_tpu/data/pipeline.py:augment_batch draws
    from ``key`` at 32x32, pad 4."""
    key_y, key_x, key_f = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(d).reshape(b)) for d in (
        jax.random.randint(key_y, (b,), 0, 9),
        jax.random.randint(key_x, (b,), 0, 9),
        jax.random.bernoulli(key_f, 0.5, (b, 1, 1, 1))))


def _draws(rng, key):
    """One M2 step's randomness: the injected latent draws, as numpy, and
    the port's replay of the crops and flips the JAX step draws from
    ``key`` (steps.py:456-458)."""
    n = {"eps_1": rng.standard_normal((B, DC)).astype(np.float32),
         "eps_2": rng.standard_normal((B, DC)).astype(np.float32),
         "unif_2": rng.random((B, K)).astype(np.float32)}
    key_aug_l, key_aug_u, _ = jax.random.split(key, 3)
    aug = {"aug_l": _jax_offsets(key_aug_l, B),
           "aug_u": _jax_offsets(key_aug_u, B)}
    return n, aug


def _jax_step(jm, params, bs, bce):
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
            0.1, [1], steps_per_epoch=1)))
    return jstate, with_tpu_dense(jax.jit(jax_steps.make_m2_train_step(
        jm, num_classes=K, bce=bce, x_sigma=1.0)))


def _port_step(pm, bce):
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    return state, make_m2_train_step(pm, opt, num_classes=K, bce=bce,
                                     x_sigma=1.0)


def _compare_state(pm, params, bs, tol, what):
    want = state_dict_from_jax(params, bs)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("bce", [False, True], ids=["mse", "bce"])
def test_m2_step_lockstep_matches_jax(models, data, bce):
    """Three M2 steps with the augmentation on and every draw replayed (LR
    warmup then a decay: 0.02, 0.1, 0.01): the loss and each of JAX's ten
    metrics, every parameter and running statistic after every step."""
    jm, _, params, bs = models
    jstate, jstep = _jax_step(jm, params, bs, bce)
    pm = _port(params, bs)
    state, step = _port_step(pm, bce)
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    rng = np.random.default_rng(2)
    batch = [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]
    for i in range(STEPS):
        key = jax.random.key(10 + i)
        n, aug = _draws(rng, key)
        jstate, want = jstep(jstate, *map(jnp.asarray, batch), sched, key,
                             {k: jnp.asarray(v) for k, v in n.items()})
        got = step(state, *map(torch.from_numpy, batch), SCHED,
                   torch.Generator().manual_seed(i), inject={**n, **aug})
        assert list(got) == M2_METRICS and set(want) == set(M2_METRICS)
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        assert state.step == i + 1
        _compare_state(pm, jstate.params, jstate.batch_stats, 1e-3,
                       f"after step {i}")


def test_m2_step_draws_from_its_generator(models, data):
    """With nothing injected: one seed gives one step, every metric is
    finite and every weight moves; the labeled forward takes the labels'
    one-hots (its discrete KL term differs from the unlabeled one)."""
    _, _, params, bs = models
    batch = [torch.from_numpy(data[k]) for k in ("img_l", "lab_l", "img_u",
                                                 "lab_u")]
    out = []
    for _ in range(2):
        pm = _port(params, bs)
        state, step = _port_step(pm, True)
        out.append((step(state, *batch, SCHED,
                         torch.Generator().manual_seed(5)), pm.state_dict()))
    (m1, s1), (m2, s2) = out
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    before = _port(params, bs).state_dict()
    assert all(not torch.equal(before[k], s1[k]) for k in before
               if k.endswith("weight"))


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def _dist(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def test_bf16_m2_step_matches_jax_bf16_step(models, data):
    """One M2 step of the bf16 model against the JAX step on the bf16
    model, every draw replayed: the loss and every metric, every parameter
    and running statistic after it, calibrated on the JAX bf16 step's
    distance from the JAX f32 step. That distance is taken as its largest
    over the step's draws and CALIBRATION_DRAWS - 1 more: bf16 rounding of
    a scalar sum lands near 0 for some draws by chance (the labeled
    discrete KL's reads 2.1e-6 on one draw and 1.3e-5 on others)."""
    jm32, jm16, params, bs = models
    rng = np.random.default_rng(3)
    keys = [jax.random.key(3 + d) for d in range(CALIBRATION_DRAWS)]
    draws = [_draws(rng, key) for key in keys]
    batch = [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    res = {}
    for tag, jm in (("jax32", jm32), ("jax16", jm16)):
        jstate0, jstep = _jax_step(jm, params, bs, True)
        res[tag] = []
        for key, (n, _) in zip(keys, draws):
            jstate, metrics = jstep(jstate0, *map(jnp.asarray, batch), sched,
                                    key, {k: jnp.asarray(v)
                                          for k, v in n.items()})
            res[tag].append({
                **{f"metric {k}": v for k, v in metrics.items()},
                **state_dict_from_jax(jstate.params, jstate.batch_stats)})
    n, aug = draws[0]
    for tag, dtype in (("port32", None), ("port16", torch.bfloat16)):
        pm = _port(params, bs, dtype)
        state, step = _port_step(pm, True)
        metrics = step(state, *map(torch.from_numpy, batch), SCHED,
                       torch.Generator().manual_seed(0), inject={**n, **aug})
        res[tag] = {**{f"metric {k}": v for k, v in metrics.items()},
                    **pm.state_dict()}
    names = [k for k in res["jax16"][0]
             if not k.endswith("num_batches_tracked")]
    assert set(names) <= set(res["port16"]) and len(names) > 80
    for k in names:
        ref = res["jax16"][0][k]
        jax_dist = max(_dist(a[k], b[k])
                       for a, b in zip(res["jax16"], res["jax32"]))
        tol = max(FLOOR * (1.0 + float(np.abs(_np(ref)).max())),
                  STEP_FACTOR * jax_dist)
        err = _dist(res["port16"][k], ref)
        assert err <= tol, (f"{k}: port bf16 {err:.3e} from JAX bf16, "
                            f"beyond {tol:.3e}")
    own = max(_dist(res["port16"][k], res["port32"][k]) for k in names)
    ref = max(_dist(res["jax16"][0][k], res["jax32"][0][k]) for k in names)
    assert OWN_RANGE[0] * ref <= own <= OWN_RANGE[1] * ref, (own, ref)


# ----------------------------------------------------------------- the loop

MILESTONES = [0, 1, 2]  # SHOT-VAE's ewm bump would fall after epoch 0
EPOCHS = 2
# shotvae_tpu/train/loop.py:398-458 for Cifar10, the same for M2
SCALAR_TAGS = {"Train/KL_Inference"} | {
    f"{s}/{m}" for s in ("Valid", "Test")
    for m in ("KL(q(z|X)||p(z))", "KL(q(y|X)||p(y))", "log(p(X|z,y))",
              "ELBO", "top1 accuracy")}


def _tiny_cfg(base, **kw):
    fields = dict(base_path=base, dataset="Cifar10", batch_size=32,
                  net_name=NET, ldc=8, synthetic_data=True,
                  synthetic_size=192, valid_per_class=10,
                  annotated_per_class=10, yes=True, epochs=1,
                  reconstruct_freq=1, print_freq=100,
                  adjust_lr=list(MILESTONES), bf16=False)
    fields.update(kw)
    return ShotVaeConfig(**fields)


@pytest.fixture(scope="module")
def m2_run(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("m2"))
    cfg = _tiny_cfg(base)
    out = run_shot_vae(cfg, m2=True, max_epochs=EPOCHS,
                       log_fn=lambda *a: None, device="cpu")
    return base, cfg, out


def test_m2_epochs_write_under_m2_vae(m2_run):
    """The checkpoint and the TensorBoard run lie under Cifar10-M2-VAE,
    nothing under Cifar10-SHOT-VAE; the tags are the SHOT-VAE loop's; the
    history has the JAX loop's keys."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    base, _, out = m2_run
    assert os.listdir(base) == ["Cifar10-M2-VAE"]
    run = os.path.join(base, "Cifar10-M2-VAE")
    pointer = os.path.join(run, "parameter", "train_time_1",
                           "checkpoint.current")
    assert os.path.isfile(open(pointer).read())
    events = EventAccumulator(os.path.join(run, "runs", "train_time:1"))
    events.Reload()
    assert set(events.Tags()["scalars"]) == SCALAR_TAGS
    assert [h["epoch"] for h in out["history"]] == list(range(EPOCHS))
    assert list(out["history"][0]) == ["epoch", "valid_top1", "test_top1",
                                       "train_loss", "train_terms", "sched",
                                       "seconds"]
    assert list(out["history"][0]["train_terms"]) == M2_METRICS
    assert out["state"].step == EPOCHS * 2


def test_m2_cmi_and_no_ewm_bump_match_jax(m2_run):
    """cmi 200 (config.py:90-114 with m2) and no ewm x5 at adjust_lr[0]
    (loop.py:478-480 bumps only without m2): each epoch's schedule equals
    the JAX package's for the same config."""
    _, cfg, out = m2_run
    assert cfg.cmi == 200 and cfg.ewm == ShotVaeConfig().ewm
    jcfg = jax_config.ShotVaeConfig(**_tiny_cfg("").asdict())
    jcfg.apply_dataset_overrides(m2=True)
    for epoch, h in enumerate(out["history"]):
        want = jax_schedules.shot_vae_epoch_schedules(epoch, jcfg)
        assert h["sched"] == {k: float(v) for k, v in want.items()}
    # the SHOT-VAE loop bumps at the same milestone
    shot = _tiny_cfg(os.path.join(os.path.dirname(m2_run[0]), "shot_bump"))
    run_shot_vae(shot, max_epochs=1, log_fn=lambda *a: None, device="cpu")
    assert shot.ewm == 5 * cfg.ewm and shot.cmi == 0
