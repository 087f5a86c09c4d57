"""The port's kernel modules and sampling math against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; here that
version is held against the JAX package's Pallas kernel, run in interpret
mode as tests/test_pallas.py runs it, or against the JAX reference function
where the Pallas kernel cannot run on the CPU (the TPU's hardware PRNG).
Inputs come from numpy seeds and go to both sides as the same numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from shotvae_tpu.data import pipeline as jax_pipeline
from shotvae_tpu.ops import sampling as jax_sampling
from shotvae_tpu.ops.pallas import fused_bn_act as jax_bn
from shotvae_tpu.ops.pallas import fused_conv as jax_conv
from shotvae_torch.data.pipeline import to_float
from shotvae_torch.ops import sampling
from shotvae_torch.ops.kernels.bn_act import bn_act_inference
from shotvae_torch.ops.kernels.fused_conv import (bn_affine_from_stats,
                                                  fused_bn_act_conv)
from shotvae_torch.ops.kernels.fused_sample import (box_muller,
                                                    fused_joint_sample,
                                                    joint_sample_from_uniforms)

T = 0.67


@pytest.fixture(autouse=True)
def interpret_mode():
    """The JAX side's Pallas kernels run in the Pallas interpreter."""
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bn_params(rng, c):
    return [rng.uniform(0.5, 1.5, c).astype(np.float32),     # weight
            rng.normal(size=c).astype(np.float32),           # bias
            rng.normal(size=c).astype(np.float32) * 0.5,     # running mean
            rng.uniform(0.5, 2.0, c).astype(np.float32)]     # running var


@pytest.mark.parametrize("slope", [0.01, 0.0])
@pytest.mark.parametrize("c", [8, 16, 128])
def test_bn_act_matches_pallas(c, slope):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(300, c)) * 2 + 1).astype(np.float32)
    params = _bn_params(rng, c)
    want = jax_bn.bn_act_inference(jnp.asarray(x),
                                   *map(jnp.asarray, params), slope=slope)
    got = bn_act_inference(_t(x), *map(_t, params), slope=slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 16, 16, 64, 64), (6, 8, 8, 128, 64)])
def test_fused_conv_matches_pallas(shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (rng.normal(size=cin) * 0.1).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    want = jax_conv.fused_bn_act_conv(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(shift), jnp.asarray(wk))
    x_nchw = _t(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = fused_bn_act_conv(x_nchw, _t(scale), _t(shift),
                            _t(wk).permute(3, 2, 0, 1))   # HWIO -> OIHW
    # tolerance as tests/test_pallas.py holds the Pallas kernel to XLA
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_bn_affine_from_stats_matches_jax():
    rng = np.random.default_rng(5)
    gamma, beta, mean, var = _bn_params(rng, 16)
    want = jax_conv.bn_affine_from_stats(*map(jnp.asarray,
                                              (mean, var, gamma, beta)))
    got = bn_affine_from_stats(*map(_t, (mean, var, gamma, beta)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_sample_from_injected_noise_matches_joint_latent():
    """The sampler's arithmetic on given uniforms equals the JAX
    ``joint_latent`` fed the same Gaussian and uniform draws."""
    rng = np.random.default_rng(6)
    b, dc, dd = 8, 8, 10
    mean = rng.normal(size=(b, dc)).astype(np.float32)
    log_sigma = (rng.normal(size=(b, dc)) * 0.3).astype(np.float32)
    logits = rng.normal(size=(b, dd)).astype(np.float32)
    log_alpha = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    u1, u2, u = (rng.uniform(size=s).astype(np.float32)
                 for s in ((b, dc), (b, dc), (b, dd)))
    got = joint_sample_from_uniforms(_t(mean), _t(log_sigma), _t(log_alpha),
                                     _t(u1), _t(u2), _t(u), T)
    eps = box_muller(_t(u1), _t(u2)).numpy()
    want = jax_sampling.joint_latent(
        jax.random.key(0), jnp.asarray(mean), jnp.asarray(log_sigma),
        jnp.asarray(log_alpha), T,
        noise={"eps": jnp.asarray(eps), "unif": jnp.asarray(u)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_plain_sampler_moments_and_simplex():
    """As tests/test_pallas.py checks the TPU kernel: z ~ N(1.5, 0.5^2),
    y on the simplex; and one generator seed gives one draw."""
    b, dc, dd = 4096, 16, 10
    mean = torch.full((b, dc), 1.5)
    log_sigma = torch.full((b, dc), float(np.log(0.5)))
    log_alpha = torch.log(torch.full((b, dd), 0.1))
    out = fused_joint_sample(mean, log_sigma, log_alpha,
                             generator=torch.Generator().manual_seed(7))
    z, y = out[:, :dc], out[:, dc:]
    assert np.isclose(float(z.mean()), 1.5, atol=0.05)
    assert np.isclose(float(z.std()), 0.5, atol=0.05)
    np.testing.assert_allclose(y.sum(1).numpy(), 1.0, rtol=1e-4)
    assert bool((y >= 0).all())
    again = fused_joint_sample(mean, log_sigma, log_alpha,
                               generator=torch.Generator().manual_seed(7))
    assert torch.equal(out, again)


def test_joint_latent_labels_and_mixup_match_jax():
    """Label substitution, -1 (unlabeled) rows and the mixup combination,
    with injected draws."""
    rng = np.random.default_rng(8)
    b, dc, dd = 6, 4, 10
    mean, log_sigma, eps = (rng.normal(size=(b, dc)).astype(np.float32)
                            for _ in range(3))
    log_alpha = np.log(rng.dirichlet(np.ones(dd), b)).astype(np.float32)
    unif = rng.uniform(size=(b, dd)).astype(np.float32)
    labels = np.array([3, -1, 0, 9, -1, 5])
    labels_mixup = np.array([1, 2, 3, 4, 5, 6])
    noise = {"eps": eps, "unif": unif}
    for kw in ({"labels": labels},
               {"labels": labels, "labels_mixup": labels_mixup,
                "mixup_lam": 0.3}):
        want = jax_sampling.joint_latent(
            jax.random.key(0), *map(jnp.asarray, (mean, log_sigma, log_alpha)), T,
            noise={k: jnp.asarray(v) for k, v in noise.items()},
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        got = sampling.joint_latent(
            *map(_t, (mean, log_sigma, log_alpha)), T,
            noise={k: _t(v) for k, v in noise.items()},
            **{k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_onehots_and_to_float_match_jax():
    rng = np.random.default_rng(9)
    alpha = rng.dirichlet(np.ones(10), 7).astype(np.float32)
    np.testing.assert_array_equal(
        sampling.eval_discrete_onehot(_t(alpha)).numpy(),
        np.asarray(jax_sampling.eval_discrete_onehot(jnp.asarray(alpha))))
    labels = np.array([0, 9, -1, 4])
    np.testing.assert_array_equal(
        sampling.label_onehot(_t(labels), 10).numpy(),
        np.asarray(jax_sampling.label_onehot(jnp.asarray(labels), 10)))
    images = rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    for normalize in (False, True):
        np.testing.assert_array_equal(
            to_float(_t(images), normalize=normalize).numpy(),
            np.asarray(jax_pipeline.to_float(jnp.asarray(images),
                                             normalize=normalize)))
