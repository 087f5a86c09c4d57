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

The same precision runs the JAX model's float32 heads, the three latent
``Dense`` heads of ``VariationalAutoEncoder`` (``cont_mean``,
``cont_log_sigma``, ``disc_inference``) and the WRN classifier's ``fc``,
with bfloat16 operands in their forward and backward products. The port
rounds them so (``shotvae_torch.models.layers.HEAD_OPERAND_DTYPE``; ROADMAP
queue 3, F7); inside ``tpu_dense()``, entered while JAX's function is
traced, those ``Dense`` modules compute so too.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
from flax import linen as nn


def _r(t):
    """``t`` rounded to bfloat16, as float32."""
    return t.astype(jnp.bfloat16).astype(jnp.float32)


def _mm(a, b):
    return _r(a) @ _r(b).T


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


# the JAX package's float32 Dense heads, by module name: the VAE's three
# latent heads (shotvae_tpu/models/vae.py:84-86) and the WRN classifier's
# ``fc`` (shotvae_tpu/models/classifier.py:45)
TPU_DENSE_NAMES = ("cont_mean", "cont_log_sigma", "disc_inference", "fc")


@jax.custom_vjp
def tpu_dense_product(x, kernel):
    """``x @ kernel`` with bfloat16 operands and float32 sums, forward and
    backward, as XLA's default precision runs it on a TPU."""
    return _r(x) @ _r(kernel)


def _product_fwd(x, kernel):
    xr, kr = _r(x), _r(kernel)
    return xr @ kr, (xr, kr)


def _product_bwd(res, g):
    xr, kr = res
    gr = _r(g)
    return gr @ kr.T, xr.T @ gr


tpu_dense_product.defvjp(_product_fwd, _product_bwd)


@jax.custom_vjp
def _forward_as(x, value):
    """``value`` in the forward; the gradient goes on to ``x``."""
    return value


_forward_as.defvjp(lambda x, value: (value, None),
                   lambda _, g: (g, jnp.zeros_like(g)))


def _gap(got, want):
    """The largest |got - want| / (1 + |want|): at most ``tol`` where
    ``assert_allclose(got, want, rtol=tol, atol=tol)`` passes."""
    return jnp.max(jnp.abs(got - want) / (1.0 + jnp.abs(want)))


def _interceptor(aligned, gaps):
    calls = []

    def intercept(next_fun, args, kwargs, context):
        module = context.module
        if not (context.method_name == "__call__"
                and isinstance(module, nn.Dense)
                and module.name in TPU_DENSE_NAMES
                and module.has_variable("params", "kernel")):
            return next_fun(*args, **kwargs)
        x = jnp.asarray(args[0], jnp.float32)
        kernel = module.get_variable("params", "kernel")
        if aligned is not None:
            assert len(calls) < len(aligned), "more head calls than aligned"
            x_port, k_port = aligned[len(calls)]
            assert x_port.shape == x.shape and k_port.shape == kernel.shape
            jax.debug.callback(lambda a, b: gaps.extend((float(a),
                                                         float(b))),
                               _gap(x, x_port), _gap(kernel, k_port))
            x, kernel = _forward_as(x, x_port), _forward_as(kernel, k_port)
        calls.append(module.name)
        y = tpu_dense_product(x, kernel)
        if module.use_bias:
            y = y + module.get_variable("params", "bias")
        return y

    return intercept


@contextlib.contextmanager
def tpu_dense(aligned=None, gaps=None):
    """Inside, the JAX heads of ``TPU_DENSE_NAMES`` compute their products
    through ``tpu_dense_product``; enter it while JAX's function is traced
    (a trace made outside keeps the float32 products).

    With ``aligned``, the port's operands of each head call in call order
    (``port_head_operands``: the input and the kernel, (in, out)), each
    JAX head call computes its forward on those and sends its gradients on
    to its own (straight through), and appends to ``gaps`` how far its own
    input and kernel lie from the port's (``_gap``). Two frameworks'
    float32 operands agree only to their rounding, about 1e-6 relative,
    and where one element straddles a bfloat16 rounding boundary the two
    roundings part by a whole bfloat16 step (2^-8 relative); aligned, the
    heads round the same values, and the gaps hold the operands
    themselves to a test's tolerance."""
    with nn.intercept_methods(_interceptor(aligned, gaps)):
        yield


@contextlib.contextmanager
def port_head_operands(model):
    """Inside, every call of one of ``model``'s float32 heads
    (``HeadLinear``) appends its (input, kernel (in, out)) as float32 numpy
    arrays to the list yielded, in call order."""
    from shotvae_torch.models.layers import HeadLinear

    record = []

    def hook(module, args):
        record.append((args[0].detach().float().numpy().copy(),
                       module.weight.detach().float().numpy().T.copy()))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, HeadLinear)]
    try:
        yield record
    finally:
        for h in hooks:
            h.remove()


def with_aligned_tpu_dense(fn, gaps):
    """``fn`` with a first argument more, the port's head operands
    (``aligned``), called inside ``tpu_dense(aligned, gaps)``."""
    @functools.wraps(fn)
    def wrapped(aligned, *args, **kwargs):
        with tpu_dense(aligned, gaps):
            return fn(*args, **kwargs)

    return wrapped


def with_tpu_dense(fn):
    """``fn`` called inside ``tpu_dense()``: a jit of it traces the heads'
    TPU arithmetic, whenever its first call comes."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with tpu_dense():
            return fn(*args, **kwargs)

    return wrapped
