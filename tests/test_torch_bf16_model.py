"""The port's bf16 SHOT-VAE and its bf16 train step against the JAX
package's ``VariationalAutoEncoder(dtype=jnp.bfloat16)``.

One JAX VAE (WRN-10-1, Dc 8, K 10) with random BN affines and running
statistics is converted with ``state_dict_from_jax``; the same f32
state_dict strict-loads into the port's f32 and bf16 models. Both sides get
the same numpy images, labels and injected draws; on the CPU the port's
kernel wrappers run their plain versions.

Tolerance, calibrated in the same run: bf16 rounds at other places in the
two frameworks (the port folds BN where flax normalises, applies LeakyReLU
in f32 before rounding where flax rounds first, within one bf16 ulp on
negative inputs, and sums in other orders), so the port is held to the JAX
bf16 model within 2x the JAX model's own distance between its bf16 and f32
outputs on the same inputs, max abs per tensor, or within a floor of 1e-6
relative to the tensor's largest value where that is larger: f32 rounding
of sums taken in other orders, for a tensor that bf16 barely moves (a
reconstruction loss of about 2,000, summed from bf16 logits near 0). After
a train step the factor is 3: each parameter then also carries its weight
gradient, which both sides round to bf16 independently (a bf16 conv's
wgrad), so the two may lie up to twice JAX's own rounding apart on top of
the forward's difference (the decoder's 1024->512 ConvTranspose weight
reads 1.2x of 2x JAX's distance). The port's own bf16-vs-f32 distance must
lie within 0.25x to 4x of the JAX model's (each taken over all outputs
together), which fails a port that silently runs f32.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

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
from shotvae_torch.train.steps import make_shot_vae_train_step
from torch_tpu_match import with_tpu_dense

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)
FACTOR = 2.0          # port vs JAX bf16, in units of JAX's bf16-vs-f32
STEP_FACTOR = 3.0     # the same after a train step (bf16 weight gradients)
FLOOR = 1e-6          # relative to the tensor's largest value
OWN_RANGE = (0.25, 4.0)  # port's bf16-vs-f32 distance over JAX's


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


def _port(params, bs, dtype):
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu", dtype=dtype)
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    return pm


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "lab_u": rng.integers(0, K, B).astype(np.int32),
            "eps": rng.normal(size=(B, DC)).astype(np.float32),
            "unif": rng.uniform(size=(B, K)).astype(np.float32)}


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def _dist(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def check_calibrated(port16, port32, jax16, jax32, what, factor=FACTOR):
    """Each tensor of ``port16`` within max(FLOOR, ``factor`` x its JAX
    bf16-vs-f32 distance) of ``jax16``; the port's own bf16-vs-f32 distance
    within OWN_RANGE of JAX's, over all tensors together."""
    for k in jax16:
        tol = max(FLOOR * (1.0 + float(np.abs(_np(jax16[k])).max())),
                  factor * _dist(jax16[k], jax32[k]))
        err = _dist(port16[k], jax16[k])
        assert err <= tol, (f"{what} {k}: port bf16 {err:.3e} from JAX bf16, "
                            f"beyond {tol:.3e} ({factor}x JAX's bf16-vs-f32)")
    own = max(_dist(port16[k], port32[k]) for k in jax16)
    ref = max(_dist(jax16[k], jax32[k]) for k in jax16)
    lo, hi = OWN_RANGE
    assert lo * ref <= own <= hi * ref, (
        f"{what}: the port's bf16-vs-f32 distance {own:.3e} is not within "
        f"{lo}x to {hi}x of JAX's {ref:.3e}")


def test_bf16_dtype_contract(models):
    """As tests/test_models.py:147-160 holds the JAX model: heads and
    reconstruction f32, parameters f32; the trunk's features bf16."""
    _, _, params, bs = models
    pm = _port(params, bs, torch.bfloat16).train()
    x = torch.rand(2, 3, 32, 32)
    for t in pm(x):
        assert t.dtype == torch.float32
    assert pm.feature_extractor(x).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(b.dtype == torch.float32 for n, b in pm.named_buffers()
               if not n.endswith("num_batches_tracked"))
    sum(t.sum() for t in pm(x)).backward()
    assert all(p.grad.dtype == torch.float32 for p in pm.parameters())


@pytest.mark.parametrize("train", [False, True])
def test_bf16_vae_matches_jax_bf16(models, data, train):
    """Eval and train mode with injected draws: the four outputs (and, in
    train mode, every running statistic after the forward) against the JAX
    bf16 model, calibrated on JAX's bf16-vs-f32 distance."""
    jm32, jm16, params, bs = models
    noise = {"eps": data["eps"], "unif": data["unif"]}
    x = data["img_u"].astype(np.float32) / 255.0
    names = ("recon", "mean", "log_sigma", "log_alpha")
    jax_out, port_out = {}, {}
    for tag, jm in (("32", jm32), ("16", jm16)):
        out = with_tpu_dense(jm.apply)(
            {"params": params, "batch_stats": bs}, jnp.asarray(x),
            train=train,
            noise={k: jnp.asarray(v) for k, v in noise.items()},
            rngs={"sample": jax.random.key(0)},
            mutable=["batch_stats"] if train else False)
        outs, stats = (out if train else (out, None))
        jax_out[tag] = dict(zip(names, outs))
        jax_out[tag]["recon"] = np.asarray(jax_out[tag]["recon"]).transpose(
            0, 3, 1, 2)
        if train:
            jax_out[tag].update(state_dict_from_jax(params,
                                                    stats["batch_stats"]))
    for tag, dtype in (("32", None), ("16", torch.bfloat16)):
        pm = _port(params, bs, dtype).train(train)
        with torch.no_grad():
            outs = pm(torch.from_numpy(x).permute(0, 3, 1, 2),
                      noise={k: torch.from_numpy(v) for k, v in noise.items()})
        port_out[tag] = dict(zip(names, outs))
        if train:
            port_out[tag].update(pm.state_dict())
    keys = [k for k in jax_out["16"] if not k.endswith("num_batches_tracked")
            and (train or k in names)]
    pick = lambda d: {k: d[k] for k in keys}  # noqa: E731
    check_calibrated(pick(port_out["16"]), pick(port_out["32"]),
                     pick(jax_out["16"]), pick(jax_out["32"]),
                     "train forward" if train else "eval forward")


def _draws(rng):
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    n["perm_mx"] = rng.permutation(B).astype(np.int32)
    return n


def test_bf16_train_step_matches_jax_bf16_step(models, data):
    """One SHOT-VAE step (bce, optimal match, augmentation off, every draw
    injected) of the bf16 model against the JAX step built on the bf16
    model: the loss and every metric, every parameter and running statistic
    after the step, calibrated on the JAX bf16 step's distance from the
    JAX f32 step."""
    jm32, jm16, params, bs = models
    n = _draws(np.random.default_rng(2))
    batch = [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    jax_res = {}
    for tag, jm in (("32", jm32), ("16", jm16)):
        jstate = jax_state.TrainState.create(
            apply_fn=jm.apply, params=params, batch_stats=bs,
            tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
                0.1, [1], steps_per_epoch=1)))
        jstep = with_tpu_dense(jax.jit(jax_steps.make_shot_vae_train_step(
            jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
            optimal_match=True, aug=jax_steps.AugmentConfig(enabled=False))))
        jstate, metrics = jstep(jstate, *map(jnp.asarray, batch), sched,
                                jax.random.key(0),
                                {k: jnp.asarray(v) for k, v in n.items()})
        jax_res[tag] = {**{f"metric {k}": v for k, v in metrics.items()},
                        **state_dict_from_jax(jstate.params,
                                              jstate.batch_stats)}
    port_res = {}
    for tag, dtype in (("32", None), ("16", torch.bfloat16)):
        pm = _port(params, bs, dtype)
        opt = sgd_torch(pm)
        state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
        step = make_shot_vae_train_step(
            pm, opt, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
            optimal_match=True, aug=False)
        metrics = step(state, *map(torch.from_numpy, batch), SCHED,
                       torch.Generator().manual_seed(0), inject=n)
        port_res[tag] = {**{f"metric {k}": v for k, v in metrics.items()},
                         **pm.state_dict()}
    keys = [k for k in jax_res["16"] if not k.endswith("num_batches_tracked")]
    pick = lambda d: {k: d[k] for k in keys}  # noqa: E731
    assert set(keys) <= set(port_res["16"])
    check_calibrated(pick(port_res["16"]), pick(port_res["32"]),
                     pick(jax_res["16"]), pick(jax_res["32"]), "train step",
                     STEP_FACTOR)


def test_config_bf16_default_and_compute_dtype():
    """``bf16`` defaults to True as in the JAX ``ShotVaeConfig``, and
    ``compute_dtype`` gives the model's ``dtype`` as loop.py:223 picks it."""
    from shotvae_tpu.config import ShotVaeConfig as JaxConfig
    from shotvae_torch.config import ShotVaeConfig

    assert ShotVaeConfig().bf16 is JaxConfig().bf16 is True
    assert ShotVaeConfig().compute_dtype() == torch.bfloat16
    assert ShotVaeConfig(bf16=False).compute_dtype() is None
