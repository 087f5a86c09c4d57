"""The port's float32 heads against the JAX package's heads as they compute
on a TPU (ROADMAP queue 3, F7).

XLA's default precision runs the JAX model's float32 ``Dense`` heads on a
TPU with bfloat16 operands and float32 sums, forward and backward; the
port's heads (``layers.HeadLinear``, under ``HEAD_OPERAND_DTYPE``) round
so too. On seeded pooled features, fed to the heads of the port's
``encode`` and of the WRN classifier's forward (a forward pre-hook puts
them in place of the trunk's), the outputs and the gradients of a seeded
scalar of them (with respect to the features and to each head's weight
and bias) equal the JAX heads under ``torch_tpu_match.tpu_dense`` within
TOL, and stand more than GAP from the JAX heads' exact float32 products:
a port whose heads compute in float32 fails. GAP is a hundred times TOL;
one bfloat16 rounding of 64 features and weights moves an output by about
1e-3 here.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.models import build_classifier as jax_build_classifier
from shotvae_tpu.train.state import init_model
from shotvae_torch.io.jax_weights import (classifier_state_dict_from_jax,
                                          state_dict_from_jax)
from shotvae_torch.models import layers
from shotvae_torch.models.classifier import build_classifier
from shotvae_torch.models.vae import VariationalAutoEncoder
from torch_tpu_match import tpu_dense

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 8
TOL = 1e-6
GAP = 100 * TOL
HEADS = ("cont_mean", "cont_log_sigma", "disc_inference")
PORT_HEADS = {"cont_mean": "continuous_inference.mean.fc",
              "cont_log_sigma": "continuous_inference.log_sigma.fc",
              "disc_inference": "disc_latent_inference.fc",
              "fc": "classification.fc"}


def _with_random_biases(params, names, rng):
    """``params`` with each named head's bias drawn (the init zeroes it)."""
    params = jax.tree_util.tree_map(np.asarray, params)
    params = {k: dict(v) if k in names else v for k, v in params.items()}
    for name in names:
        params[name]["bias"] = rng.normal(
            0, 0.1, params[name]["bias"].shape).astype(np.float32)
    return params


def _features(seed: int, width: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        0, 1, (B, width)).astype(np.float32)


def _port_grads(pm, forward, names, avg):
    """``forward()`` with ``avg`` in place of each named head's input, the
    seeded scalar's gradients: {name: (weight (in, out), bias)} and the
    features'."""
    leaf = torch.from_numpy(avg).requires_grad_()
    modules = {n: pm.get_submodule(PORT_HEADS[n]) for n in names}
    pm.requires_grad_(False)  # the eval-mode trunk's kernels take no grad
    for m in modules.values():
        m.requires_grad_(True)
    hooks = [m.register_forward_pre_hook(lambda m, args: (leaf,))
             for m in modules.values()]
    try:
        outs = forward()
    finally:
        for h in hooks:
            h.remove()
    outs = outs if isinstance(outs, tuple) else (outs,)
    scalar = sum((o * torch.from_numpy(c)).sum()
                 for o, c in zip(outs, _cotangents(outs)))
    scalar.backward()
    grads = {n: (m.weight.grad.T.numpy(), m.bias.grad.numpy())
             for n, m in modules.items()}
    return [o.detach().numpy() for o in outs], grads, leaf.grad.numpy()


def _cotangents(outs):
    rng = np.random.default_rng(5)
    return [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in outs]


def _jax_grads(apply, params, names, avg, tpu: bool):
    """``apply(params, avg, arithmetic)`` (a tuple of outputs), which
    enters ``arithmetic()`` around the JAX model's apply: the heads' TPU
    arithmetic where ``tpu``. The outputs and the seeded scalar's
    gradients, as ``_port_grads`` returns them."""
    def run(p, a):
        return apply(p, a, tpu_dense if tpu else contextlib.nullcontext)

    outs = run(params, jnp.asarray(avg))
    cots = _cotangents(outs)

    def scalar(p, a):
        return sum(jnp.sum(o * c) for o, c in zip(run(p, a), cots))

    gp, ga = jax.jit(jax.grad(scalar, argnums=(0, 1)))(params,
                                                        jnp.asarray(avg))
    grads = {n: (np.asarray(gp[n]["kernel"]), np.asarray(gp[n]["bias"]))
             for n in names}
    return [np.asarray(o) for o in outs], grads, np.asarray(ga)


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _hold(port, tpu, exact, names):
    """The port equal to the TPU-matched JAX heads within TOL (abs + rel)
    and more than GAP from the exact ones, output by output and for the
    gradients."""
    (po, pg, pa), (to, tg, ta), (eo, eg, ea) = port, tpu, exact
    pairs = list(zip(po, to, eo)) + [(pa, ta, ea)] + [
        (pg[n][i], tg[n][i], eg[n][i]) for n in names for i in (0, 1)]
    for got, want, _ in pairs:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # every output and the weights' and features' gradients move with the
    # operands' rounding; a bias gradient is g.sum(0), exact on both sides
    for got, _, far in pairs[:len(po) + 1] + [
            (pg[n][0], None, eg[n][0]) for n in names]:
        assert _dist(got, far) > GAP


@pytest.fixture(scope="module")
def vae():
    jm = JaxVAE(encoder_name=NET, continuous_latent_dim=DC,
                disc_latent_dim=K)
    params, bs = init_model(jm, jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    params = _with_random_biases(params, HEADS, np.random.default_rng(2))
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu").eval()
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    return jm, params, bs, pm


def test_head_operands_are_bfloat16():
    assert layers.HEAD_OPERAND_DTYPE == torch.bfloat16


def test_encode_heads_take_the_tpus_operands(vae):
    """The port's ``encode`` (eval mode) on seeded pooled features: its
    three heads and the gradients through them equal JAX's heads at the
    TPU's arithmetic, and not its exact float32 heads."""
    jm, params, bs, pm = vae
    avg = _features(3, pm.feature_extractor.num_feature_channel)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(B, 3, 32, 32)).astype(np.float32))
    port = _port_grads(pm, lambda: pm.encode(x), HEADS, avg)

    def heads(m, a):
        return (m.cont_mean(a), m.cont_log_sigma(a),
                jax.nn.log_softmax(m.disc_inference(a), axis=1))

    def apply(p, a, arithmetic):
        with arithmetic():
            return jm.apply({"params": p, "batch_stats": bs}, a,
                            method=heads)

    _hold(port, _jax_grads(apply, params, HEADS, avg, True),
          _jax_grads(apply, params, HEADS, avg, False), HEADS)


def test_classifier_logits_take_the_tpus_operands():
    """The port's WRN classifier (eval mode) on seeded pooled features in
    place of its trunk's: the logits and their gradients equal the JAX
    classifier's ``fc`` at the TPU's arithmetic (its input put in place
    by an interceptor entered inside ``tpu_dense``), and not its exact
    float32 ``fc``."""
    jm = jax_build_classifier(NET, K)
    params, bs = init_model(jm, jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    params = _with_random_biases(params, ("fc",), np.random.default_rng(2))
    pm = build_classifier(NET, K, device="cpu").eval()
    pm.load_state_dict(classifier_state_dict_from_jax(params, bs),
                       strict=True)
    avg = _features(3, params["fc"]["kernel"].shape[0])
    x = np.random.default_rng(4).uniform(size=(B, 32, 32, 3)).astype(
        np.float32)
    port = _port_grads(pm, lambda: pm(torch.from_numpy(x).permute(
        0, 3, 1, 2)), ("fc",), avg)

    def apply(p, a, arithmetic):
        def features_in_place(next_fun, args, kwargs, context):
            if context.module.name == "fc" \
                    and context.method_name == "__call__":
                return next_fun(a, **kwargs)
            return next_fun(*args, **kwargs)

        # the first interceptor entered is the outermost
        with nn.intercept_methods(features_in_place), arithmetic():
            return (jm.apply({"params": p, "batch_stats": bs},
                             jnp.asarray(x), train=False),)

    _hold(port, _jax_grads(apply, params, ("fc",), avg, True),
          _jax_grads(apply, params, ("fc",), avg, False), ("fc",))
