"""Fused joint latent draw (Gaussian + Gumbel-softmax), as a CUDA C++ kernel.

Replaces ``fused_joint_sample`` (shotvae_tpu/ops/pallas/fused_sample.py:57,
kernel ``_sample_kernel`` :38): one kernel, ``shotvae_torch/csrc/
fused_sample.cu``, draws the Box-Muller Gaussian
``z = mu + exp(log_sigma) * eps`` and the Gumbel-softmax
``y = softmax((log_alpha + g) / T)`` and writes ``[z ; y]``, shape
(B, Dc + Dd), f32. The source's header says what bounds it on the H100 and
how its design answers that.

The random numbers are Philox-4x32-10 words, keyed by one 31-bit seed drawn
from the caller's ``torch.Generator`` (the Hopper counterpart of
``pltpu.prng_seed`` / ``prng_random_bits``), each taken to a uniform on the
TPU kernel's grid: ``(w >> 8) * 2^-24``. ``sample_counters`` is the one
place that says which counter feeds which element; ``philox_uniforms``
draws them in plain PyTorch, and ``joint_sample_from_uniforms`` applied to
them is the kernel's plain version. So one seed gives one draw on the CPU
and on the card, up to the rounding of the transcendentals. The reference
constructions are kept exactly: ``u1 + 1e-12`` inside the Box-Muller log,
and ``g = -log(-log(u + EPS) + EPS)``.

On the CPU the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. Like the JAX kernel it has no gradient: under grad
mode, an input that requires grad raises (training draws through
``sampling.joint_latent``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from shotvae_torch.ops.kernels import (_build, count_launch, init_counts,
                                      refuse_grad)
from shotvae_torch.ops.sampling import draw_seed, gumbel_softmax_from_uniform

_TWO_PI = 2.0 * math.pi
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments
GAUSS_STREAM, GUMBEL_STREAM = 0, 1    # counter word c1 of each stream


def _mulhilo(m: int, x):
    """(high, low) 32-bit words of m * x, for 32-bit m and x (ints or int64
    tensors), with no intermediate above 2^49."""
    low = m * (x & 0xFFFF)
    high = m * (x >> 16)
    mid = low + ((high & 0xFFFF) << 16)
    return (high >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 (Random123) of the counter (c0, c1, c2, c3) under the
    key (k0, k1): its four 32-bit output words. Counters are ints or int64
    tensors of 32-bit values, which broadcast."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def sample_counters(b: int, dc: int, dd: int, device=None):
    """The Philox counters of one (b, dc, dd) draw, each a tuple (c0, c1, c2,
    c3) of (b, n) int64 tensors: Gaussian pair j of row r, columns 2j and
    2j + 1, is (j, 0, r, 0); Gumbel group q of row r, columns 4q to 4q + 3,
    is (q, 1, r, 0). The key is (seed, 0)."""
    def counters(n: int, stream: int):
        rows = torch.arange(b, device=device)[:, None].expand(b, n)
        cols = torch.arange(n, device=device)[None, :].expand(b, n)
        return (cols, torch.full_like(cols, stream), rows,
                torch.zeros_like(cols))
    return counters(-(-dc // 2), GAUSS_STREAM), counters(-(-dd // 4),
                                                         GUMBEL_STREAM)


def uniform_from_word(w):
    """U[0, 1) from a 32-bit word: its high 24 bits times 2^-24, exact in f32
    (shotvae_tpu/ops/pallas/fused_sample.py:29 ``_uniform``)."""
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def philox_uniforms(seed: int, b: int, dc: int, dd: int, device=None):
    """The kernel's uniforms for ``seed``: (u1, u2) of shape (b, dc) and u of
    shape (b, dd), f32. One Philox call gives u1, u2 of columns 2j (words 0,
    1) and 2j + 1 (words 2, 3), or u of columns 4q to 4q + 3."""
    gauss, gumbel = sample_counters(b, dc, dd, device)
    w = [uniform_from_word(x) for x in philox4x32(*gauss, seed, 0)]
    u1 = torch.stack((w[0], w[2]), 2).reshape(b, -1)[:, :dc]
    u2 = torch.stack((w[1], w[3]), 2).reshape(b, -1)[:, :dc]
    u = torch.stack([uniform_from_word(x) for x in philox4x32(*gumbel, seed,
                                                              0)], 2)
    return u1, u2, u.reshape(b, -1)[:, :dd]


def box_muller(u1, u2):
    """N(0, 1) from two U[0,1) draws, u1 nudged off zero (:44-45)."""
    return torch.sqrt(-2.0 * torch.log(u1 + 1e-12)) * torch.cos(_TWO_PI * u2)


def joint_sample_from_uniforms(mean, log_sigma, log_alpha, u1, u2, u,
                               temperature: float = 0.67):
    """[z ; y] from given uniforms: the kernel's arithmetic as plain ops."""
    z = mean + torch.exp(log_sigma) * box_muller(u1, u2)
    return torch.cat([z, gumbel_softmax_from_uniform(log_alpha, u,
                                                     temperature)], dim=1)


def fused_joint_sample_plain(mean, log_sigma, log_alpha,
                             temperature: float = 0.67, *, seed: int):
    """The plain version: the kernel's draw for ``seed``, on the tensors'
    device, from ``philox_uniforms``."""
    b, dc = mean.shape
    return joint_sample_from_uniforms(
        mean, log_sigma, log_alpha,
        *philox_uniforms(seed, b, dc, log_alpha.shape[1], mean.device),
        temperature)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sample")
    if lib.fused_joint_sample_f32.argtypes is None:
        lib.fused_joint_sample_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
        lib.fused_joint_sample_f32.restype = ctypes.c_int
        lib.fused_sample_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.fused_sample_empty.restype = ctypes.c_int
    return lib


def empty_launch(device, blocks: int = 1) -> None:
    """Launch the source's empty kernel (``blocks`` blocks of 256 threads)
    on ``device``'s current stream, uncounted: the floor of one launch."""
    err = _lib().fused_sample_empty(
        blocks, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def fused_joint_sample(mean, log_sigma, log_alpha, temperature: float = 0.67,
                       *, generator: Optional[torch.Generator] = None):
    """[z ; y] sample, shape (B, Dc + Dd) f32, seeded from ``generator``.
    It has no gradient: an input that requires grad under grad mode
    raises."""
    refuse_grad("fused_joint_sample", "the reparameterised "
                "shotvae_torch.ops.sampling.joint_latent (a train-mode "
                "VariationalAutoEncoder forward takes it)",
                mean, log_sigma, log_alpha)
    seed = draw_seed(generator)
    if mean.device.type == "cpu":
        return fused_joint_sample_plain(mean, log_sigma, log_alpha,
                                        temperature, seed=seed)
    tensors = (mean, log_sigma, log_alpha)
    if (any(t.dim() != 2 or t.dtype != torch.float32
            or t.device != mean.device or not t.is_contiguous()
            for t in tensors)
            or log_sigma.shape != mean.shape
            or log_alpha.shape[0] != mean.shape[0] or 0 in mean.shape
            or log_alpha.shape[1] == 0):
        raise ValueError("fused_sample kernel takes contiguous float32 "
                         "(B, Dc), (B, Dc), (B, Dd), B, Dc and Dd at least "
                         "1, on one card")
    b, dc = mean.shape
    dd = log_alpha.shape[1]
    out = torch.empty((b, dc + dd), device=mean.device, dtype=torch.float32)
    err = _lib().fused_joint_sample_f32(
        mean.data_ptr(), log_sigma.data_ptr(), log_alpha.data_ptr(),
        out.data_ptr(), b, dc, dd, seed, float(temperature),
        torch.cuda.current_stream(mean.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_sample kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(fused_joint_sample, out.dtype)
    return out


init_counts(fused_joint_sample)
