"""The port's smooth-ELBO trainers against the JAX package: the loss terms
and their gradients, the two samplers and the capacity ramp, the
``SmoothVAE`` of both configurations at full width (train and eval mode,
f32 and bf16), the weight bridge both ways, the init law, the train step
in a 3-step lockstep with ``make_smooth_elbo_train_step`` for MNIST and
SVHN, the eval step with a ragged mask, ``ReduceLROnPlateau``, the MNIST
resize, and one tiny epoch of ``run_smooth_elbo`` on each dataset.

Both sides get the same numpy inputs and, where the model draws, the same
injected draws (the JAX step's ``inject`` layout); JAX weights are
converted with the port's ``smooth_vae_state_dict_from_jax`` and
strict-loaded into the port's model.

Tolerances: each loss and its gradient within 1e-5 relative; the samplers
1e-6; the f32 model's outputs 1e-5 (abs + rel); the bf16 model within 3x
the JAX bf16 model's own distance from the JAX f32 model (with a floor of
1e-6 of the output's largest value). The lockstep holds the loss and every
metric within 1e-4 relative, with an absolute floor of 1e-6 times the
size of the terms a metric is the difference of: the discrete KL is
log K minus an entropy of nearly log K, so its f32 rounding is that of
log K (a few ulp, about 1e-6 absolute where the KL itself is 3e-5), and a
discrete capacity term is gamma_d times that; the other metrics take a
floor of 1e-6. Every parameter and both Adam moments within 1e-3 (abs +
rel) after each step, except Adam's tiny-gradient elements: after a step
from small moments, an element whose gradient is within rounding of 0
moves by about +-lr whatever its sign, so two frameworks may put it 2 lr
apart. Such an element (its first moment under TINY of its tensor's
largest, in the JAX state) is held by its moments instead, and counted;
once excused it stays so, since its parameter stays apart.
"""

import math
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotvae_tpu import config as jax_config
from shotvae_tpu.data import pipeline as jax_pipeline
from shotvae_tpu.data import splits as jax_splits
from shotvae_tpu.io import torch_compat, torch_export
from shotvae_tpu.models import SmoothVAE as JaxSmoothVAE
from shotvae_tpu.models import smooth_vae as jax_smooth_vae
from shotvae_tpu.ops import losses as jax_losses
from shotvae_tpu.ops import sampling as jax_sampling
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import loop as jax_loop
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.config import SmoothElboConfig, svhn_smooth_defaults
from shotvae_torch.data import pipeline
from shotvae_torch.io.jax_weights import smooth_vae_state_dict_from_jax
from shotvae_torch.models.smooth_vae import (SmoothVAE, mnist_vae_config,
                                             svhn_vae_config)
from shotvae_torch.ops import losses, sampling, schedules
from shotvae_torch.train import loop
from shotvae_torch.train.state import TrainState, adam_torch
from shotvae_torch.train.steps import (make_smooth_elbo_eval_step,
                                       make_smooth_elbo_train_step)

K = 10
B, BL = 8, 4          # unlabeled and labeled batches of the lockstep
STEPS = 3
TOL_LOSS = 1e-5       # each loss term and its gradient, relative
TOL_MODEL = 1e-5      # the f32 model's outputs, abs + rel
TOL_METRIC = 1e-4     # the lockstep's metrics, relative ...
METRIC_FLOOR = 1e-6   # ... plus this much of the terms they cancel
TOL_STATE = 1e-3      # parameters and Adam moments, abs + rel
TINY = 1e-5           # Adam's tiny-gradient elements: |mu| under this of
#                       the tensor's largest
BF16_FACTOR = 3.0
BF16_FLOOR = 1e-6
# (config, image channels, Adam lr, alpha, cont capacity, disc capacity):
# the CLI defaults of each dataset (config.py:134-169)
CONFIGS = {
    "mnist": (mnist_vae_config, jax_smooth_vae.mnist_vae_config, 1, 5e-4,
              50.0, (0.0, 17.5, 25000, 30.0), (0.0, 17.0, 25000, 30.0)),
    "svhn": (svhn_vae_config, jax_smooth_vae.svhn_vae_config, 3, 1e-3,
             1500.0, (0.0, 50.0, 50000, 1.0), (0.0, 50.0, 50000, 1.0)),
}
# shotvae_tpu/train/steps.py:650-659
METRICS = {"loss", "u_recon", "u_cont_cap", "u_disc_cap", "l_recon",
           "l_cont_cap", "l_disc_cap", "classification", "kl_cont",
           "kl_disc", "kl_cont_per_dim"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these tests use
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


# ----------------------------------------------------------------- losses

def _loss_cases(rng):
    """name -> (port function, JAX function, numpy args); each function
    returns a scalar and is differentiated in its first argument."""
    mean = rng.normal(0, 1, (6, 10)).astype(np.float32)
    logvar = rng.normal(0, 0.5, (6, 10)).astype(np.float32)
    alpha = rng.dirichlet(np.ones(K), 6).astype(np.float32)
    alpha2 = rng.dirichlet(np.ones(4), 6).astype(np.float32)
    x = rng.uniform(-1, 1, (6, 3, 8, 8)).astype(np.float32)
    recon = rng.uniform(-1, 1, (6, 3, 8, 8)).astype(np.float32)
    onehot = np.eye(K, dtype=np.float32)[rng.integers(0, K, 6)]
    log_q = np.log(alpha)
    sigma_p = rng.uniform(0.5, 1.5, (6, 10)).astype(np.float32)
    mean_p = rng.normal(0, 1, (6, 10)).astype(np.float32)
    kl = np.float32(3.0)
    return {
        "smooth_recon_loss": (losses.smooth_recon_loss,
                              jax_losses.smooth_recon_loss, (recon, x)),
        "kl_normal_loss": (lambda m, v: losses.kl_normal_loss(m, v)[0],
                           lambda m, v: jax_losses.kl_normal_loss(m, v)[0],
                           (mean, logvar)),
        "kl_normal_loss per dim": (
            lambda m, v: (losses.kl_normal_loss(m, v)[1] ** 2).sum(),
            lambda m, v: (jax_losses.kl_normal_loss(m, v)[1] ** 2).sum(),
            (mean, logvar)),
        "kl_discrete_loss": (losses.kl_discrete_loss,
                             jax_losses.kl_discrete_loss, (alpha,)),
        "kl_multiple_discrete_loss": (
            lambda a, b: losses.kl_multiple_discrete_loss([a, b]),
            lambda a, b: jax_losses.kl_multiple_discrete_loss([a, b]),
            (alpha, alpha2)),
        "capacity_loss": (
            lambda k: losses.capacity_loss(k, 7000, 0.0, 17.5, 25000, 30.0),
            lambda k: jax_losses.capacity_loss(k, 7000, 0.0, 17.5, 25000,
                                               30.0), (kl,)),
        "capacity_loss at cap_max": (
            lambda k: losses.capacity_loss(k, 30000, 0.0, 17.5, 25000, 30.0),
            lambda k: jax_losses.capacity_loss(k, 30000, 0.0, 17.5, 25000,
                                               30.0), (kl,)),
        "capacity_loss theoretical_max": (
            lambda k: losses.capacity_loss(k, 20000, 0.0, 17.0, 25000, 30.0,
                                           theoretical_max=math.log(10)),
            lambda k: jax_losses.capacity_loss(
                k, 20000, 0.0, 17.0, 25000, 30.0,
                theoretical_max=float(np.log(10))), (kl,)),
        "bce_probs_mean": (losses.bce_probs_mean, jax_losses.bce_probs_mean,
                           (alpha, onehot)),
        "gaussian_kl_general std": (losses.gaussian_kl_general,
                                    jax_losses.gaussian_kl_general,
                                    (mean, logvar)),
        "gaussian_kl_general p": (
            lambda m, s: losses.gaussian_kl_general(m, s, _t(mean_p),
                                                    _t(sigma_p)),
            lambda m, s: jax_losses.gaussian_kl_general(m, s, mean_p,
                                                        sigma_p),
            (mean, logvar)),
        "categorical_kl qp": (lambda q: losses.categorical_kl(
            q, _t(alpha2[:, :1].repeat(K, 1) / 4)),
            lambda q: jax_losses.categorical_kl(
                q, alpha2[:, :1].repeat(K, 1) / 4), (log_q,)),
        "categorical_kl pq": (lambda q: losses.categorical_kl(
            q, _t(alpha), qp_order=False),
            lambda q: jax_losses.categorical_kl(q, alpha, qp_order=False),
            (log_q,)),
    }


LOSS_NAMES = list(_loss_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_matches_jax_with_its_gradient(name):
    port, ref, args = _loss_cases(np.random.default_rng(0))[name]
    want, want_grad = jax.value_and_grad(ref)(*map(jnp.asarray, args))
    first = _t(args[0]).clone().requires_grad_(True)
    got = port(first, *map(_t, args[1:]))
    got.backward()
    _close(float(got.detach()), float(want), TOL_LOSS, name)
    _close(first.grad.numpy(), np.asarray(want_grad), TOL_LOSS, name)


def test_bce_probs_mean_saturated_gives_jaxs_finite_gradient():
    """q(y|x) at exactly 0 and 1: the forward clamps at -100, and the
    gradient is torch's (p - t) / max(p (1 - p), 1e-12), finite and equal
    to the JAX package's custom VJP, not NaN."""
    p = np.array([[0.0, 1.0, 0.5, 1.0], [1.0, 0.0, 0.0, 0.25]], np.float32)
    t = np.array([[0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0]], np.float32)
    want, want_grad = jax.value_and_grad(jax_losses.bce_probs_mean)(
        jnp.asarray(p), jnp.asarray(t))
    q = _t(p).clone().requires_grad_(True)
    got = losses.bce_probs_mean(q, _t(t))
    got.backward()
    assert bool(torch.isfinite(q.grad).all())
    _close(float(got.detach()), float(want), TOL_LOSS)
    _close(q.grad.numpy(), np.asarray(want_grad), TOL_LOSS)
    assert float(q.grad.abs().max()) > 1e9  # large where p(1-p) is 0


def test_samplers_and_capacity_match_jax():
    rng = np.random.default_rng(1)
    mean = rng.normal(0, 1, (5, 7)).astype(np.float32)
    logvar = rng.normal(0, 1, (5, 7)).astype(np.float32)
    eps = rng.standard_normal((5, 7)).astype(np.float32)
    alpha = rng.dirichlet(np.ones(K), 5).astype(np.float32)
    alpha[0, 3] = 0.0  # log(0 + 1e-12)
    unif = rng.uniform(1e-4, 1 - 1e-4, (5, K)).astype(np.float32)
    key = jax.random.key(0)
    _close(sampling.sample_gaussian_logvar(_t(mean), _t(logvar),
                                           eps=_t(eps)).numpy(),
           jax_sampling.sample_gaussian_logvar(key, mean, logvar, eps=eps),
           1e-6)
    _close(sampling.sample_gumbel_softmax_probs(_t(alpha), 0.67,
                                                unif=_t(unif)).numpy(),
           jax_sampling.sample_gumbel_softmax_probs(key, alpha, 0.67,
                                                    unif=unif), 1e-6)
    g = torch.Generator().manual_seed(3)
    drawn = sampling.sample_gumbel_softmax_probs(_t(alpha), 0.67,
                                                 generator=g)
    assert torch.allclose(drawn.sum(1), torch.ones(5))
    for step in (0, 1, 7, 12345, 25000, 40000):
        for args in ((0.0, 17.5, 25000), (0.0, 50.0, 50000), (1.0, 5.0, 3)):
            want = float(jax_schedules.linear_capacity(step, *args))
            assert schedules.linear_capacity(step, *args) == want


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def jax_models():
    """name -> (JAX model, params with random biases, config)."""
    out = {}
    for i, (name, spec) in enumerate(CONFIGS.items()):
        cfg = spec[1]()
        jm = JaxSmoothVAE(**cfg)
        params, _ = jax_state.init_model(jm, jax.random.key(i),
                                         jnp.zeros((2, 32, 32, spec[2])))
        rng = np.random.default_rng(10 + i)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + (rng.normal(0, 0.05, a.shape).astype(
                np.float32) if a.ndim == 1 else 0), params)
        out[name] = (jm, params, cfg)
    return out


def _bridge(params, cfg):
    return smooth_vae_state_dict_from_jax(
        params, encoder_channels=cfg["encoder_channels"],
        reshape_channels=cfg["reshape_channels"])


def _port_model(name, params, dtype=None):
    cfg = CONFIGS[name][0]()
    pm = SmoothVAE(**cfg, dtype=dtype, device="cpu")
    pm.load_state_dict(_bridge(params, cfg), strict=True)
    return pm


def _forward_inputs(name, seed=2):
    c = CONFIGS[name][2]
    dc = CONFIGS[name][0]()["latent_cont_dim"]
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (4, 32, 32, c)).astype(np.float32),
            np.array([3, 0, 9, 3]),
            {"eps": rng.standard_normal((4, dc)).astype(np.float32),
             "unif": [rng.uniform(1e-4, 1 - 1e-4, (4, K)).astype(
                 np.float32)]})


def _jax_forward(jm, params, x, labels, noise, train):
    return jm.apply({"params": params}, jnp.asarray(x),
                    labels=None if labels is None else jnp.asarray(labels),
                    train=train, noise=jax.tree_util.tree_map(jnp.asarray,
                                                              noise),
                    rngs={"sample": jax.random.key(1)})


def _port_forward(pm, x, labels, noise, train):
    pm.train(train)
    with torch.no_grad():
        return pm(_t(x).permute(0, 3, 1, 2),
                  labels=None if labels is None else _t(labels),
                  noise={"eps": _t(noise["eps"]),
                         "unif": [_t(u) for u in noise["unif"]]})


def _outputs(out, nchw: bool):
    """(recon NHWC, mean, logvar, alphas..., latent, disc samples...)."""
    recon, dist, latent, disc = out
    recon = np.asarray(recon.permute(0, 2, 3, 1) if nchw else recon)
    return [recon, *map(np.asarray, dist["cont"]),
            *map(np.asarray, dist["disc"]), np.asarray(latent),
            *map(np.asarray, disc)]


@pytest.mark.parametrize("labeled", [False, True], ids=["unlabeled",
                                                        "labeled"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_smooth_vae_matches_jax(jax_models, name, train, labeled):
    """Full width at batch 4: the reconstruction, both heads, the latent
    sample and the discrete samples. Train mode draws (injected); eval
    mode takes the mean and the argmax one-hot; the labeled path puts the
    label's one-hot in the latent and still returns head 0's draw."""
    jm, params, _ = jax_models[name]
    x, labels, noise = _forward_inputs(name)
    labels = labels if labeled else None
    want = _outputs(_jax_forward(jm, params, x, labels, noise, train), False)
    got_raw = _port_forward(_port_model(name, params), x, labels, noise,
                            train)
    got = _outputs(got_raw, True)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        _close(g, w, TOL_MODEL, f"output {i}")
    dc = CONFIGS[name][0]()["latent_cont_dim"]
    latent, disc = got_raw[2], got_raw[3][0]
    if labeled:
        assert torch.equal(latent[:, dc:], torch.eye(K)[labels])
        assert not torch.equal(disc, latent[:, dc:]) or not train
    if not train:
        assert torch.equal(latent[:, :dc], got_raw[1]["cont"][0])


def test_export_keys_load_strictly_and_round_trip(jax_models):
    """Every key of ``export_smooth_vae_state_dict``'s output strict-loads
    into the port's model of each configuration, equal to the port's
    bridge value for value; a port state_dict through JAX's
    ``import_smooth_vae_state_dict`` and back is equal bit for bit."""
    for name, (_, params, cfg) in jax_models.items():
        kw = dict(encoder_channels=cfg["encoder_channels"],
                  reshape_channels=cfg["reshape_channels"])
        exported = torch_export.export_smooth_vae_state_dict(params, **kw)
        pm = SmoothVAE(**CONFIGS[name][0](), device="cpu")
        assert set(exported) == set(pm.state_dict()) == set(
            _bridge(params, cfg))
        pm.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in exported.items()}, strict=True)
        for k, v in _bridge(params, cfg).items():
            assert torch.equal(v, torch.as_tensor(np.array(exported[k]))), k
        fresh = SmoothVAE(**CONFIGS[name][0](), device="cpu")
        sd = {k: v.detach().clone() for k, v in fresh.state_dict().items()}
        jax_params, _ = torch_compat.import_smooth_vae_state_dict(sd, **kw)
        back = smooth_vae_state_dict_from_jax(jax_params, **kw)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


def test_init_law_is_the_jax_packages():
    """Each conv, ConvTranspose and Linear weight is U(+-1/sqrt(fan_in))
    with the JAX package's fan_in (``torch_default_init``: the input
    channels times the receptive field, for a ConvTranspose too, where
    torch's default takes the output channels), filling its range with
    that law's variance; every bias 0. Each bound is the one JAX's
    ``torch_default_init`` draws within for the layer's flax kernel (for a
    ConvTranspose, (4, 4, cin, cout)). One seed gives one model."""
    from shotvae_tpu.models.layers import torch_default_init

    for name in CONFIGS:
        cfg = CONFIGS[name][0]()
        model = SmoothVAE(**cfg, device="cpu")
        layers = [m for m in model.modules() if isinstance(
            m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
        assert len(layers) == 3 + 1 + 3 + 2 + 3
        for i, m in enumerate(layers):
            w = m.weight.detach()
            if isinstance(m, torch.nn.Linear):
                flax_shape = (w.shape[1], w.shape[0])
            elif isinstance(m, torch.nn.ConvTranspose2d):  # (cin, cout, k, k)
                flax_shape = (*w.shape[2:], w.shape[0], w.shape[1])
            else:  # (cout, cin, k, k)
                flax_shape = (*w.shape[2:], w.shape[1], w.shape[0])
            fan_in = math.prod(flax_shape[:-1])
            bound = 1.0 / math.sqrt(fan_in)
            jax_w = np.asarray(torch_default_init(jax.random.key(i),
                                                  flax_shape, jnp.float32))
            assert float(np.abs(jax_w).max()) <= bound * (1 + 1e-6)
            assert float(np.abs(jax_w).max()) > 0.99 * bound
            assert float(w.abs().max()) <= bound
            assert float(w.abs().max()) > 0.9 * bound
            if w.numel() > 2000:
                assert abs(float(w.var()) / (bound**2 / 3) - 1) < 0.1
            assert not m.bias.any()
    cfg = SmoothElboConfig()
    a, b = (loop.build_smooth_model(cfg, "mnist", "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_forward_at_the_calibrated_bound(jax_models, name):
    """One bf16 forward in train mode (injected draws) and one in eval
    mode: each output of the port's bf16 model within 3x the JAX bf16
    model's distance from the JAX f32 model (floor 1e-6 of the output's
    largest value); the hidden layer returns to f32 and the outputs are
    f32."""
    jm, params, cfg = jax_models[name]
    jm16 = JaxSmoothVAE(**cfg, dtype=jnp.bfloat16)
    x, labels, noise = _forward_inputs(name, seed=4)
    pm16 = _port_model(name, params, torch.bfloat16)
    for train in (True, False):
        w32 = _outputs(_jax_forward(jm, params, x, labels, noise, train),
                       False)
        w16 = _outputs(_jax_forward(jm16, params, x, labels, noise, train),
                       False)
        got = _outputs(_port_forward(pm16, x, labels, noise, train), True)
        for i, (g, a, b) in enumerate(zip(got, w16, w32)):
            assert g.dtype == np.float32
            tol = max(BF16_FLOOR * (1 + float(np.abs(a).max())),
                      BF16_FACTOR * _dist(a, b))
            assert _dist(g, a) <= tol, (train, i, _dist(g, a), tol)


# ------------------------------------------------------------------- step

def _lockstep_setup(jax_models, name):
    jm, params, cfg = jax_models[name]
    _, _, c, lr, alpha, cont, disc = CONFIGS[name]
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats={},
        tx=jax_state.adam_torch(lr))
    jstep = jax.jit(jax_steps.make_smooth_elbo_train_step(
        jm, alpha=alpha, cont_capacity=cont, disc_capacity=disc,
        disc_dims=(K,)))
    pm = _port_model(name, params)
    opt = adam_torch(pm, lr)
    state = TrainState(pm, opt)
    step = make_smooth_elbo_train_step(pm, opt, alpha=alpha,
                                       cont_capacity=cont,
                                       disc_capacity=disc, disc_dims=(K,))
    return jstate, jstep, state, step, cfg


def _step_inputs(rng, name):
    c = CONFIGS[name][2]
    dc = CONFIGS[name][0]()["latent_cont_dim"]
    return (rng.integers(0, 256, (B, 32, 32, c), dtype=np.uint8),
            rng.integers(0, 256, (BL, 32, 32, c), dtype=np.uint8),
            rng.integers(0, K, BL).astype(np.int32),
            {s: {"eps": rng.standard_normal((n, dc)).astype(np.float32),
                 "unif": [rng.uniform(1e-4, 1 - 1e-4, (n, K)).astype(
                     np.float32)]} for s, n in (("u", B), ("l", BL))})


def _metric_floor(name, key):
    """The size of the terms a metric is the difference of."""
    gamma_d = CONFIGS[name][6][3]
    return {"kl_disc": math.log(K), "u_disc_cap": gamma_d * math.log(K),
            "l_disc_cap": gamma_d * math.log(K)}.get(key, 1.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_lockstep_matches_jax(jax_models, name):
    """Three smooth-ELBO steps at B + BL with every draw injected: the
    loss and JAX's metrics (``kl_cont_per_dim`` included), the step
    counter, then every parameter and both Adam moments after each step;
    Adam's tiny-gradient elements are counted and held by their moments."""
    jstate, jstep, state, step, cfg = _lockstep_setup(jax_models, name)
    pm, opt = state.model, state.optimizer
    rng = np.random.default_rng(5)
    excused = {}
    for i in range(STEPS):
        img_u, img_l, lab_l, inject = _step_inputs(rng, name)
        jstate, want = jstep(jstate, jnp.asarray(img_u), jnp.asarray(img_l),
                             jnp.asarray(lab_l), jax.random.key(i),
                             jax.tree_util.tree_map(jnp.asarray, inject))
        got = step(state, _t(img_u), _t(img_l), _t(lab_l), None, inject)
        assert set(got) == set(want) == METRICS
        assert got["kl_cont_per_dim"].shape == (cfg["latent_cont_dim"],)
        for k in got:
            w = np.asarray(want[k])
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=TOL_METRIC,
                atol=METRIC_FLOOR * _metric_floor(name, k),
                err_msg=f"step {i}: {k}")
        assert state.step == i + 1 and int(jstate.step) == i + 1
        adam = jstate.opt_state[0]
        want_p, want_mu, want_nu = (_bridge(t, cfg) for t in (
            jstate.params, adam.mu, adam.nu))
        for k, p in pm.named_parameters():
            st = opt.state[p]
            for what, g, w in (("exp_avg", st["exp_avg"], want_mu[k]),
                               ("exp_avg_sq", st["exp_avg_sq"], want_nu[k])):
                _close(g.numpy(), w.numpy(), TOL_STATE,
                       f"step {i}: {what} of {k}")
            bad = ((p.detach() - want_p[k]).abs()
                   > TOL_STATE * (1 + want_p[k].abs()))
            tiny = want_mu[k].abs() <= TINY * want_mu[k].abs().max()
            excused[k] = excused.get(k, torch.zeros_like(bad)) | (bad & tiny)
            left = bad & ~excused[k]
            assert not left.any(), (
                f"step {i}: {int(left.sum())} elements of {k} beyond "
                f"{TOL_STATE}, max {float((p - want_p[k]).abs().max()):.3e}")
    count = sum(int(v.sum()) for v in excused.values())
    print(f"{name}: {count} tiny-gradient elements excused")
    assert count <= 0.001 * sum(p.numel() for p in pm.parameters())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_step_matches_jax_with_a_ragged_mask(jax_models, name):
    jm, params, _ = jax_models[name]
    c = CONFIGS[name][2]
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (8, 32, 32, c), dtype=np.uint8)
    lab = rng.integers(0, K, 8).astype(np.int32)
    weight = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=params,
                                         batch_stats={},
                                         tx=jax_state.adam_torch(1e-3))
    want = jax_steps.make_smooth_elbo_eval_step(jm)(
        jstate, jnp.asarray(img), jnp.asarray(lab), jnp.asarray(weight))
    pm = _port_model(name, params)
    pm.train()
    got = make_smooth_elbo_eval_step(pm)(_t(img), _t(lab), _t(weight))
    assert not pm.training
    assert set(got) == set(want) == {"correct_count", "count"}
    for k in got:
        assert float(got[k]) == float(want[k]), k
    assert float(got["count"]) == 5.0


def test_plateau_matches_jax():
    """The same scale sequence as the JAX class over losses that improve,
    improve within the 1e-4 relative threshold (not counted), stall past
    the patience twice, then improve again."""
    seq = [10.0, 9.0, 8.9995, 8.9994] + [9.5] * 12 + [8.99, 8.0] + \
        [8.0 * (1 - 5e-5)] * 12 + [1.0]
    port, ref = loop.ReduceLROnPlateau(), jax_loop.ReduceLROnPlateau()
    got = [port.step(v) for v in seq]
    want = [ref.step(v) for v in seq]
    assert got == want
    assert got[-1] == pytest.approx(0.01) and 1.0 in got
    small = (loop.ReduceLROnPlateau(patience=1),
             jax_loop.ReduceLROnPlateau(patience=1))
    assert [small[0].step(v) for v in (1.0, 0.99999, 0.99998)] == \
        [small[1].step(v) for v in (1.0, 0.99999, 0.99998)]


def test_resize_is_bit_equal_to_jax():
    """28 -> 32 bilinear on seeded uint8 images, before and after the
    loop's round-half-even and clip to uint8."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (16, 28, 28, 1), dtype=np.uint8)
    imgs[0] = 255
    imgs[1, ::2] = 0
    want = np.asarray(jax_pipeline.resize_batch(
        jnp.asarray(imgs, jnp.float32), 32))
    got = pipeline.resize_batch(_t(imgs), 32)
    assert got.shape == (16, 32, 32, 1) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    want_u8 = np.asarray(jnp.clip(jnp.round(want), 0, 255), dtype=np.uint8)
    got_u8 = torch.clamp(torch.round(got), 0, 255).to(torch.uint8)
    assert np.array_equal(got_u8.numpy(), want_u8)
    three = rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    assert np.array_equal(
        pipeline.resize_batch(_t(three), 32).numpy(),
        np.asarray(jax_pipeline.resize_batch(jnp.asarray(three, jnp.float32),
                                             32)))


# ------------------------------------------------------------------- loop

# shotvae_tpu/train/loop.py:790-808
LOG_LINES = [
    r"Epoch: \d+ Average loss: -?[\d.]+ Test Accuracy: [\d.]+",
    r"u_recon_loss: -?[\d.]+, u_cont: -?[\d.]+, u_disc: -?[\d.]+",
    r"l_recon_loss: -?[\d.]+, l_cont: -?[\d.]+, l_disc: -?[\d.]+, "
    r"class: -?[\d.]+", ""]
HISTORY_KEYS = ["epoch", "test_acc", "mean_loss", "train_terms", "lr_scale"]
TRAIN_TERMS = METRICS - {"kl_cont_per_dim"}
MNIST_TRAIN, MNIST_TEST = 300, 120


def _write_mnist(root, prefix, images, labels):
    os.makedirs(root, exist_ok=True)
    n, h, w = images.shape
    with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, h, w) + images.tobytes())
    with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


class _Recording(pipeline.DeviceDataset):
    """A resident dataset that records the index arrays it gathers."""

    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []
        _Recording.made.append(self)

    def gather(self, indices):
        self.calls.append(np.asarray(indices))
        return super().gather(indices)


def _run(monkeypatch, cfg, dataset, epochs, lrs=None):
    _Recording.made = []
    monkeypatch.setattr(loop, "DeviceDataset", _Recording)
    if lrs is not None:
        make = loop.make_smooth_elbo_train_step

        def recording(model, optimizer, **kw):
            step = make(model, optimizer, **kw)

            def run(state, *a, **k):
                lrs.append(optimizer.param_groups[0]["lr"])
                return step(state, *a, **k)
            return run
        monkeypatch.setattr(loop, "make_smooth_elbo_train_step", recording)
    out = loop.run_smooth_elbo(cfg, dataset, max_epochs=epochs,
                               log_fn=lambda *a: None, device="cpu")
    train_ds, _ = _Recording.made
    return out, train_ds.calls


def _jax_streams(labels, cfg, epochs):
    """The unlabeled and labeled index batches of the JAX loop's epochs
    (loop.py:696-768), from its own pipeline functions."""
    labeled = jax_splits.labeled_subset_per_class(
        labels, cfg.size_labeled_data, 10, seed=cfg.seed)
    rng_u = np.random.default_rng(cfg.seed + 1)
    lab_iter = jax_pipeline.infinite_batches(
        np.random.default_rng(cfg.seed + 2), labeled, cfg.labeled_batch_size)
    out = []
    for _ in range(epochs):
        for idx_u in jax_pipeline.epoch_batches(
                rng_u, np.arange(len(labels)), cfg.unlabeled_batch_size):
            out += [idx_u, next(lab_iter)]
    return out


def _check_run(base, out, calls, want_calls, dataset, epochs):
    assert len(calls) == len(want_calls)
    for got, want in zip(calls, want_calls):
        assert np.array_equal(got, want)
    name = f"{dataset.upper()}-One-Stage-VAE"
    assert sorted(os.listdir(base)) == sorted(
        [name] + (["dataset"] if dataset == "mnist" else []))
    assert sorted(os.listdir(os.path.join(base, name))) == [
        f"{name}.txt", "parameter"]
    assert out["log_path"] == os.path.join(base, name, f"{name}.txt")
    lines = open(out["log_path"]).read().split("\n")
    assert len(lines) == len(LOG_LINES) * epochs + 1
    for i, line in enumerate(lines[:-1]):
        assert re.fullmatch(LOG_LINES[i % len(LOG_LINES)], line), line
    for h in out["history"]:
        assert list(h) == HISTORY_KEYS
        assert set(h["train_terms"]) == TRAIN_TERMS
        assert math.isfinite(h["mean_loss"]) and 0.0 <= h["test_acc"] <= 1.0
        assert f"Average loss: {h['mean_loss']:.2f} " in lines[
            len(LOG_LINES) * h["epoch"]]
    pointer = os.path.join(base, name, "parameter", "train_time_1",
                           "checkpoint.current")
    payload = torch.load(open(pointer).read(), weights_only=True)
    assert payload["epoch"] == epochs and payload["step"] == \
        out["state"].step
    model = out["state"].model
    fresh = SmoothVAE(**{**(mnist_vae_config() if dataset == "mnist"
                            else svhn_vae_config())}, device="cpu")
    fresh.load_state_dict(payload["state_dict"], strict=True)
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), model.state_dict().values()))
    assert len(out["epoch_times"]) == epochs


def test_mnist_epoch_resizes_idx_images_and_follows_jax_streams(
        monkeypatch, tmp_path):
    """One epoch on a written 28x28 idx set: the resize runs (the resident
    images are JAX's resize, round and clip), the unlabeled and labeled
    index batches are the JAX loop's, the log has the JAX text, the history
    its keys, and the checkpoint lands under MNIST-One-Stage-VAE and
    strict-loads equal to the final weights."""
    rng = np.random.default_rng(8)
    base = str(tmp_path)
    data = {}
    for prefix, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        _write_mnist(os.path.join(base, "dataset", "mnist"), prefix, images,
                     labels)
        data[prefix] = (images, labels)
    cfg = SmoothElboConfig(base_path=base, unlabeled_batch_size=64,
                           labeled_batch_size=4, test_batch_size=50,
                           size_labeled_data=50)
    out, calls = _run(monkeypatch, cfg, "mnist", 1)
    train_ds = _Recording.made[0]
    want_img = np.asarray(jnp.clip(jnp.round(jax_pipeline.resize_batch(
        jnp.asarray(data["train"][0][..., None], jnp.float32), 32)), 0, 255),
        dtype=np.uint8)
    assert np.array_equal(train_ds.images.numpy(), want_img)
    want = _jax_streams(data["train"][1].astype(np.int32), cfg, 1)
    _check_run(base, out, calls, want, "mnist", 1)
    assert out["state"].step == MNIST_TRAIN // 64
    assert [h["lr_scale"] for h in out["history"]] == [1.0]


def test_svhn_epochs_take_the_plateau_scale_from_the_next_epoch(
        monkeypatch, tmp_path):
    """Two SVHN epochs through the synthetic fallback (2,048 images) at
    ``svhn_smooth_defaults`` but batches of 128 + 64, the plateau on (a
    stub scale of 0.5 after every epoch): epoch 0 trains at 1e-3, epoch 1
    at 5e-4; the streams, log, history and checkpoint as for MNIST."""
    base = str(tmp_path)
    cfg = svhn_smooth_defaults()
    cfg.base_path, cfg.synthetic_data = base, True
    cfg.unlabeled_batch_size, cfg.labeled_batch_size = 128, 64
    cfg.test_batch_size = 256

    class Halves:
        def step(self, metric):
            assert math.isfinite(metric)
            return 0.5

    monkeypatch.setattr(loop, "ReduceLROnPlateau", Halves)
    lrs = []
    out, calls = _run(monkeypatch, cfg, "svhn", 2, lrs)
    labels = jax_loop.synthetic_dataset(2048, (32, 32, 3), 10,
                                        seed=0).labels
    _check_run(base, out, calls, _jax_streams(labels, cfg, 2), "svhn", 2)
    assert lrs == [1e-3] * 16 + [5e-4] * 16
    assert [h["lr_scale"] for h in out["history"]] == [1.0, 0.5]
    assert jax_config.svhn_smooth_defaults().asdict() == \
        svhn_smooth_defaults().asdict()
    assert jax_config.SmoothElboConfig().asdict() == \
        SmoothElboConfig().asdict()
