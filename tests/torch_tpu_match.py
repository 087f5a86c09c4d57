"""The JAX package's optimal-match KL as it computes on a TPU, for the
port's tests that hold the port's optimal match against JAX's.

``shotvae_tpu/ops/mixup.py:pairwise_gaussian_kl`` expands the pairwise
Gaussian KL into three float32 matrix products; XLA's default precision
runs a float32 matmul on a TPU with its operands rounded to bfloat16 and
float32 sums, and the JAX package sets no other precision, so its
learning results took their optimal-match partners from that
arithmetic. On the CPU XLA computes the products in float32. The port
rounds the operands as the TPU does (``shotvae_torch.ops.mixup.
MATCH_OPERAND_DTYPE``; ROADMAP queue 3, F6); a test patches
``tpu_pairwise_gaussian_kl`` over JAX's while JAX's step is traced, so
that both sides pick the partners of the TPU's arithmetic.
"""

import jax.numpy as jnp


def _mm(a, b):
    r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    return r(a) @ r(b).T


def tpu_pairwise_gaussian_kl(z_mean, z_log_sigma):
    """JAX's ``pairwise_gaussian_kl`` with its three products' operands
    rounded to bfloat16, the products exact and the sums float32."""
    z_mean = jnp.asarray(z_mean, jnp.float32)
    z_log_sigma = jnp.asarray(z_log_sigma, jnp.float32)
    dim = z_mean.shape[1]
    var = jnp.exp(2.0 * z_log_sigma)
    inv_var = jnp.exp(-2.0 * z_log_sigma)
    ls_row = jnp.sum(z_log_sigma, axis=1)
    term_logdet = ls_row[None, :] - ls_row[:, None]
    term_trace = 0.5 * _mm(var, inv_var)
    mu_sq = z_mean * z_mean
    term_mahal = 0.5 * (_mm(mu_sq, inv_var)
                        - 2.0 * _mm(z_mean, z_mean * inv_var)
                        + jnp.sum(mu_sq * inv_var, axis=1)[None, :])
    return term_logdet + term_trace + term_mahal - 0.5 * dim
