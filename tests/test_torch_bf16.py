"""The bf16 route of the port's kernels against the JAX package in bf16.

On the CPU the kernel wrappers run their plain versions; here they take
bfloat16 data, as the JAX package's bf16 trunk gives its kernels, and are
held against ``bn_leaky_train`` and ``bn_act_inference`` run in Pallas
interpret mode (as tests/test_pallas.py:83-93 runs them in bf16), against
``bn_leaky_train_reference``, and against ``reference_bn_act_conv`` and its
``jax.vjp`` at the four ``CONV_SHAPES``. Inputs come from numpy seeds.

Tolerances. A bf16 output is held elementwise to one bf16 ulp: both sides
compute in f32 and round once to bf16, and an f32 intermediate that
differs in its last bits (another summation order, the port's folded
affine) can round to the neighbouring bf16 value, 2**-7 relative at most;
plus an f32 slack of 1e-6 for values that cancel to near 0. Where a bf16
output is computed from another rounded bf16 value (dx from the bf16 d(act)
of the conv backward), an ulp of the first can become two of the second:
two ulps. f32 statistics are held at 1e-5. f32 sums over the rows of bf16
gradients (dgamma, dbeta, dscale, dshift), and the bf16 weight gradient,
are held norm-wise to one bf16 ulp of the largest sum: their terms are bf16
values that may each differ by an ulp. So is the train-mode fused site's y:
its forward folds BN into x * scale + shift where the JAX composition
normalises, (x - mean) * invstd * gamma + beta, so a bf16 activation
differs by an ulp in places, which moves a conv output by up to an ulp of
its largest terms, not of itself; and the site's dx, the BN backward of
the bf16 d(act), where an ulp of d(act) passes through the cancellation in
g' - (sum g' + xhat * sum g' xhat) / M. The LeakyReLU is applied in f32 before
the one rounding on both sides here (in the Pallas kernels and the
reference as in the port's kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from shotvae_tpu.ops.pallas import fused_bn_act as jax_bn
from shotvae_tpu.ops.pallas import fused_conv as jax_conv
from shotvae_torch.ops.kernels import bn_leaky
from shotvae_torch.ops.kernels.bn_act import bn_act_inference
from shotvae_torch.ops.kernels.fused_conv import (fused_bn_act_conv,
                                                  fused_bn_act_conv_plain,
                                                  fused_bn_act_conv_train,
                                                  fused_bn_act_conv_train_plain)

CONV_SHAPES = [(8, 8, 8, 128, 128), (4, 16, 16, 64, 64), (2, 32, 32, 32, 32),
               (6, 8, 8, 128, 64)]
ULP = 2.0 ** -7    # one bf16 ulp, relative, at most
SLACK = 1e-6       # f32 slack where an output cancels to about 0
TOL_STATS = 1e-5


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


def _f32(a):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def within_ulp(got, want, what="", ulps=1):
    """Elementwise: |got - want| <= ``ulps`` bf16 ulps of want + SLACK."""
    got, want = _f32(got), _f32(want)
    bad = np.abs(got - want) > ulps * ULP * np.abs(want) + SLACK
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond "
                           f"{ulps} bf16 ulp; max abs diff "
                           f"{np.abs(got - want).max():.3e}")


def within_ulp_normwise(got, want, what=""):
    """max |got - want| <= one bf16 ulp of max |want|."""
    got, want = _f32(got), _f32(want)
    diff, scale = np.abs(got - want).max(), np.abs(want).max()
    assert diff <= ULP * scale + SLACK, (f"{what}: max abs diff {diff:.3e}, "
                                         f"beyond one bf16 ulp of {scale:.3e}")


def _bf16(a, grad=False):
    """numpy f32 -> torch bf16 (rounded) and the same values as JAX bf16."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t.requires_grad_(grad), jnp.asarray(a, jnp.bfloat16)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _bn_data(m, c, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(m, c)) * 2 + 1).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            rng.normal(size=(m, c)).astype(np.float32))


@pytest.mark.parametrize("slope", [0.01, 0.0])
@pytest.mark.parametrize("m,c", [(300, 32), (129, 16)])
def test_bn_leaky_train_bf16_matches_pallas(m, c, slope):
    """Rows 1-4: statistics, apply, backward reduce and backward apply in
    bf16, through the port's autograd Function, against the Pallas kernels
    (interpret mode) and the jnp reference."""
    x, gamma, beta, g = _bn_data(m, c, m + c)
    xs, xj = _bf16(x, True)
    gs, gj = _bf16(g)
    want, vjp = jax.vjp(
        lambda x_, g_, b_: jax_bn.bn_leaky_train(x_, g_, b_, 1e-5, slope),
        xj, jnp.asarray(gamma), jnp.asarray(beta))
    ref = jax_bn.bn_leaky_train_reference(xj, jnp.asarray(gamma),
                                          jnp.asarray(beta), 1e-5, slope)
    want_grads = vjp((gj, jnp.zeros(c), jnp.zeros(c)))
    gamma_t, beta_t = _t(gamma, True), _t(beta, True)
    y, mean, var = bn_leaky.bn_leaky_train(xs, gamma_t, beta_t, 1e-5, slope)
    assert y.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    for w in (want, ref):
        within_ulp(y, w[0], "y")
        np.testing.assert_allclose(_f32(mean), _f32(w[1]), rtol=TOL_STATS,
                                   atol=TOL_STATS, err_msg="mean")
        np.testing.assert_allclose(_f32(var), _f32(w[2]), rtol=TOL_STATS,
                                   atol=TOL_STATS, err_msg="var")
    y.backward(gs)
    assert xs.grad.dtype == torch.bfloat16 and want_grads[0].dtype == jnp.bfloat16
    within_ulp(xs.grad, want_grads[0], "dx")
    within_ulp_normwise(gamma_t.grad, want_grads[1], "dgamma")
    within_ulp_normwise(beta_t.grad, want_grads[2], "dbeta")


@pytest.mark.parametrize("slope", [0.01, 0.0])
def test_bn_act_inference_bf16_matches_pallas(slope):
    """Row 5: the eval-mode kernel's plain version in bf16 (scale and shift
    folded in f32) against the Pallas kernel in interpret mode."""
    x, gamma, beta, _ = _bn_data(64, 24, 2)
    rng = np.random.default_rng(3)
    rm = rng.normal(size=24).astype(np.float32) * 0.3
    rv = rng.uniform(0.5, 2.0, 24).astype(np.float32)
    xs, xj = _bf16(x)
    want = jax_bn.bn_act_inference(xj, *map(jnp.asarray, (gamma, beta, rm,
                                                          rv)),
                                   1e-5, slope)
    got = bn_act_inference(xs, *map(_t, (gamma, beta, rm, rv)), 1e-5, slope)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    within_ulp(got, want, "y")


def _conv_inputs(shape, seed=3):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            rng.uniform(0.5, 1.5, cin).astype(np.float32),
            (rng.normal(size=cin) * 0.1).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32))


def _nchw(x_nhwc, dtype=torch.bfloat16, grad=False):
    return _t(x_nhwc).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(grad)


def _oihw(w_hwio, grad=False):
    return _t(w_hwio).permute(3, 2, 0, 1).contiguous().requires_grad_(grad)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_bf16_and_its_vjp_match_jax(shape):
    """Row 6, the eval-mode site in bf16: the plain version's output and the
    VJP of (x, scale, shift, w) against ``reference_bn_act_conv`` and its
    ``jax.vjp`` in bf16 (the activation rounded to bf16 before the conv, the
    f32 weight cast to bf16, dx cast back to bf16)."""
    x, scale, shift, wk = _conv_inputs(shape)
    g = np.random.default_rng(4).normal(
        size=shape[:3] + (shape[4],)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want, vjp = jax.vjp(jax_conv.reference_bn_act_conv, xj,
                        *map(jnp.asarray, (scale, shift, wk)))
    want_grads = vjp(jnp.asarray(g, jnp.bfloat16))
    xs, ws = _nchw(x, grad=True), _oihw(wk, True)
    ss, hs = _t(scale, True), _t(shift, True)
    got = fused_bn_act_conv(xs, ss, hs, ws)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    within_ulp(got.permute(0, 2, 3, 1), want, "y")
    within_ulp(fused_bn_act_conv_plain(xs, ss, hs, ws).permute(0, 2, 3, 1),
               want, "plain y")
    got.backward(_nchw(g))
    assert xs.grad.dtype == torch.bfloat16 and ws.grad.dtype == torch.float32
    within_ulp(xs.grad.permute(0, 2, 3, 1), want_grads[0], "dx", ulps=2)
    for a, b, name in ((ss.grad, want_grads[1], "dscale"),
                       (hs.grad, want_grads[2], "dshift"),
                       (ws.grad.permute(2, 3, 1, 0), want_grads[3], "dw")):
        within_ulp_normwise(a, b, name)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_train_site_bf16_matches_jax(shape):
    """The train-mode site in bf16: values, f32 batch statistics and the
    gradients of x, gamma, beta and w against jax.vjp of the JAX
    composition (the Pallas ``bn_leaky_train`` on bf16 rows, then the bf16
    conv), and the site's plain version against the same."""
    x, gamma, beta, wk = _conv_inputs(shape, seed=5)
    x = x * 1.5 + 0.3
    g = np.random.default_rng(6).normal(
        size=shape[:3] + (shape[4],)).astype(np.float32)
    c = shape[3]

    def jax_site(x_, gamma_, beta_, w_):
        y, mean, var = jax_bn.bn_leaky_train(x_.reshape(-1, c), gamma_, beta_)
        out = jax_conv.lax.conv_general_dilated(
            y.reshape(x_.shape), w_.astype(x_.dtype), (1, 1),
            ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return out, mean, var

    want, vjp = jax.vjp(jax_site, jnp.asarray(x, jnp.bfloat16),
                        *map(jnp.asarray, (gamma, beta, wk)))
    want_grads = vjp((jnp.asarray(g, jnp.bfloat16), jnp.zeros(c),
                      jnp.zeros(c)))
    for fn in (fused_bn_act_conv_train, fused_bn_act_conv_train_plain):
        xs, ws = _nchw(x, grad=True), _oihw(wk, True)
        gs, bs = _t(gamma, True), _t(beta, True)
        y, mean, var = fn(xs, gs, bs, ws)
        assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
        within_ulp_normwise(y.permute(0, 2, 3, 1), want[0],
                            f"{fn.__name__} y")
        np.testing.assert_allclose(_f32(mean), _f32(want[1]), rtol=TOL_STATS,
                                   atol=TOL_STATS)
        np.testing.assert_allclose(_f32(var), _f32(want[2]), rtol=TOL_STATS,
                                   atol=TOL_STATS)
        y.backward(_nchw(g))
        within_ulp_normwise(xs.grad.permute(0, 2, 3, 1), want_grads[0],
                            f"{fn.__name__} dx")
        for a, b, name in ((gs.grad, want_grads[1], "dgamma"),
                           (bs.grad, want_grads[2], "dbeta"),
                           (ws.grad.permute(2, 3, 1, 0), want_grads[3],
                            "dw")):
            within_ulp_normwise(a, b, f"{fn.__name__} {name}")
