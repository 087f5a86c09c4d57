"""The port's training-mode BN kernels and fused conv gradients against JAX.

On the CPU the ``bn_leaky`` wrappers and the fused conv run their plain
versions; here they are held, through their ``torch.autograd.Function``s,
against the JAX package's ``bn_leaky_train`` and ``fused_bn_act_conv`` run
in Pallas interpret mode, as tests/test_pallas.py runs them. Inputs come
from numpy seeds.

Tolerances, as tests/test_pallas.py holds the Pallas kernels to their
references: 1e-4 on the BN forward (y, mean, var), 2e-3 on its gradients;
2e-4 on the conv forward and 1e-3 on the conv gradients (f32 sums of
9*Cin and of B*H*W terms in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from shotvae_tpu.ops.pallas import fused_bn_act as jax_bn
from shotvae_tpu.ops.pallas import fused_conv as jax_conv
from shotvae_torch.ops.kernels.bn_leaky import bn_leaky_train
from shotvae_torch.ops.kernels.fused_conv import (fused_bn_act_conv,
                                                  fused_bn_act_conv_train,
                                                  fused_bn_act_conv_train_plain)

CONV_SHAPES = [(8, 8, 8, 128, 128), (4, 16, 16, 64, 64), (2, 32, 32, 32, 32),
               (6, 8, 8, 128, 64)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once, and the port's
    many small CPU ops slow down many times over when every process also
    runs a pool of intra-op threads; these tests use one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("slope", [0.01, 0.0])
@pytest.mark.parametrize("m,c", [(300, 32), (129, 16)])
def test_bn_leaky_train_matches_pallas(m, c, slope):
    rng = np.random.default_rng(m + c)
    x = (rng.normal(size=(m, c)) * 2 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32)
    g = _cotangent((m, c), 1)
    want, vjp = jax.vjp(
        lambda x_, g_, b_: jax_bn.bn_leaky_train(x_, g_, b_, 1e-5, slope),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want_grads = vjp((jnp.asarray(g), jnp.zeros(c), jnp.zeros(c)))
    xs, gs, bs = _t(x, True), _t(gamma, True), _t(beta, True)
    got = bn_leaky_train(xs, gs, bs, 1e-5, slope)
    for a, b, name in zip(got, want, ("y", "mean", "var")):
        _close(a.detach(), b, 1e-4, name)
    got[0].backward(_t(g))
    for a, b, name in zip((xs.grad, gs.grad, bs.grad), want_grads,
                          ("dx", "dgamma", "dbeta")):
        _close(a, b, 2e-3, name)


def _conv_inputs(shape, seed=3):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            rng.uniform(0.5, 1.5, cin).astype(np.float32),
            (rng.normal(size=cin) * 0.1).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32))


def _nchw(x_nhwc, grad=False):
    return _t(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(grad)


def _oihw(w_hwio, grad=False):
    return _t(w_hwio).permute(3, 2, 0, 1).contiguous().requires_grad_(grad)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_vjp_matches_jax(shape):
    """The eval-mode site carries the JAX VJP of (x, scale, shift, w)."""
    x, scale, shift, wk = _conv_inputs(shape)
    g = _cotangent(shape[:3] + (shape[4],), 4)
    want, vjp = jax.vjp(jax_conv.fused_bn_act_conv, *map(jnp.asarray,
                                                         (x, scale, shift,
                                                          wk)))
    want_grads = vjp(jnp.asarray(g))
    xs, ws = _nchw(x, True), _oihw(wk, True)
    ss, hs = _t(scale, True), _t(shift, True)
    got = fused_bn_act_conv(xs, ss, hs, ws)
    _close(got.detach().permute(0, 2, 3, 1), want, 2e-4, "y")
    got.backward(_nchw(g))
    grads = (xs.grad.permute(0, 2, 3, 1), ss.grad, hs.grad,
             ws.grad.permute(2, 3, 1, 0))
    for a, b, name in zip(grads, want_grads, ("dx", "dscale", "dshift",
                                              "dw")):
        _close(a, b, 1e-3, name)


def _jax_train_site(x, gamma, beta, w):
    """conv(leaky(BN_train(x))) in JAX: the Pallas bn_leaky_train, then the
    conv, NHWC."""
    rows = x.reshape(-1, x.shape[-1])
    y, mean, var = jax_bn.bn_leaky_train(rows, gamma, beta)
    out = lax.conv_general_dilated(y.reshape(x.shape), w, (1, 1),
                                   ((1, 1), (1, 1)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return out, mean, var


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_train_site_matches_jax(shape):
    """The train-mode site: values, batch statistics and the gradients of
    x, gamma, beta and w against jax.vjp of the JAX composition."""
    x, gamma, beta, wk = _conv_inputs(shape, seed=5)
    x = x * 1.5 + 0.3
    g = _cotangent(shape[:3] + (shape[4],), 6)
    want, vjp = jax.vjp(_jax_train_site, *map(jnp.asarray,
                                              (x, gamma, beta, wk)))
    c = shape[3]
    want_grads = vjp((jnp.asarray(g), jnp.zeros(c), jnp.zeros(c)))
    xs, ws = _nchw(x, True), _oihw(wk, True)
    gs, bs = _t(gamma, True), _t(beta, True)
    y, mean, var = fused_bn_act_conv_train(xs, gs, bs, ws)
    _close(y.detach().permute(0, 2, 3, 1), want[0], 2e-4, "y")
    _close(mean, want[1], 1e-4, "mean")
    _close(var, want[2], 1e-4, "var")
    y.backward(_nchw(g))
    grads = (xs.grad.permute(0, 2, 3, 1), gs.grad, bs.grad,
             ws.grad.permute(2, 3, 1, 0))
    for a, b, name in zip(grads, want_grads, ("dx", "dgamma", "dbeta",
                                              "dw")):
        _close(a, b, 1e-3, name)
    # the plain composition chip_smoke.py holds the kernels to agrees too
    xp, gp, bp, wp = (t.detach().clone().requires_grad_()
                      for t in (xs, gs, bs, ws))
    yp = fused_bn_act_conv_train_plain(xp, gp, bp, wp)[0]
    _close(yp.detach(), y.detach(), 2e-4, "plain y")
    yp.backward(_nchw(g))
    for a, b in zip((xp, gp, bp, wp), (xs, gs, bs, ws)):
        _close(a.grad, b.grad, 1e-3, "plain grads")
