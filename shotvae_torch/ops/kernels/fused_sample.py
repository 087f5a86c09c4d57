"""Fused joint latent draw (Gaussian + Gumbel-softmax), as a Triton kernel.

Replaces ``fused_joint_sample`` (shotvae_tpu/ops/pallas/fused_sample.py:57,
kernel ``_sample_kernel`` :38): one kernel draws the Box-Muller Gaussian
``z = mu + exp(log_sigma) * eps`` and the Gumbel-softmax
``y = softmax((log_alpha + g) / T)`` and writes ``[z ; y]``, shape
(B, Dc + Dd), f32.

What bounds it on the H100: memory, though at serving sizes (768 x 138
floats) launch latency is larger still. Its work is a few transcendentals
per element and a row softmax over Dd = 10; the least time is the bytes of
mu, log_sigma, log_alpha and the output over 3.35 TB/s. The design keeps
the random numbers and the Gumbel logits in registers: one program owns a
block of rows, draws its uniforms from Philox (``tl.rand``, a counter-based
generator keyed by (seed, offset), the Hopper counterpart of
``pltpu.prng_seed`` / ``prng_random_bits``), and does the softmax over the
row in registers.

The reference constructions are kept exactly: ``u1 + 1e-12`` inside the
Box-Muller log, and ``g = -log(-log(u + EPS) + EPS)``. Philox gives other
bits than the TPU's generator, so the two are compared by their moments;
the plain version below takes the same uniforms through the same arithmetic.
The seed is one draw from the caller's ``torch.Generator``.

On the CPU the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from shotvae_torch.ops.sampling import gumbel_softmax_from_uniform

_TWO_PI = 2.0 * math.pi
_BLOCK_B = 32
tl = None  # triton.language, bound by _compiled() on the first launch


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
                             temperature: float = 0.67, *,
                             generator: Optional[torch.Generator] = None):
    """The plain version: uniforms drawn by ``torch.rand`` from
    ``generator``, on the tensors' device (other bits than the kernel's
    Philox stream, the same law)."""
    draw = lambda like: torch.rand(like.shape,  # noqa: E731
                                   generator=generator, device=like.device,
                                   dtype=torch.float32)
    u1, u2, u = draw(mean), draw(mean), draw(log_alpha)
    return joint_sample_from_uniforms(mean, log_sigma, log_alpha, u1, u2, u,
                                      temperature)


def _sample_kernel(mean_ptr, log_sigma_ptr, log_alpha_ptr, out_ptr, B, DC,
                   DD, seed, temperature, BLOCK_B: tl.constexpr,
                   BLOCK_DC: tl.constexpr, BLOCK_DD: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    row_ok = rows[:, None] < B
    width = DC + DD
    # Gaussian half: u1, u2 from one Philox call per element, counters
    # 0 .. B*DC-1
    cc = tl.arange(0, BLOCK_DC)[None, :]
    cmask = row_ok & (cc < DC)
    cidx = rows[:, None] * DC + cc
    u1, u2, _, _ = tl.rand4x(seed, cidx)
    mean = tl.load(mean_ptr + cidx, mask=cmask, other=0.0)
    log_sigma = tl.load(log_sigma_ptr + cidx, mask=cmask, other=0.0)
    eps = tl.sqrt(-2.0 * tl.log(u1 + 1e-12)) * tl.cos(6.283185307179586 * u2)
    z = mean + tl.exp(log_sigma) * eps
    tl.store(out_ptr + rows[:, None] * width + cc, z, mask=cmask)
    # Gumbel-softmax half: counters B*DC .. B*DC + B*DD - 1; 1e-12 is
    # sampling.GUMBEL_EPS (a jitted kernel reads no plain Python globals)
    dcol = tl.arange(0, BLOCK_DD)[None, :]
    dmask = row_ok & (dcol < DD)
    didx = rows[:, None] * DD + dcol
    u = tl.rand(seed, B * DC + didx)
    log_alpha = tl.load(log_alpha_ptr + didx, mask=dmask, other=0.0)
    gumbel = -tl.log(-tl.log(u + 1e-12) + 1e-12)
    logit = tl.where(dmask, (log_alpha + gumbel) / temperature, float("-inf"))
    logit = logit - tl.max(logit, axis=1)[:, None]
    e = tl.where(dmask, tl.exp(logit), 0.0)
    y = e / tl.sum(e, axis=1)[:, None]
    tl.store(out_ptr + rows[:, None] * width + DC + dcol, y, mask=dmask)


@functools.cache
def _compiled():
    """Import Triton and wrap the kernel on first use: importing this module
    must work where Triton is not installed."""
    global tl
    import triton
    import triton.language

    tl = triton.language
    # a new seed per call must not select a new specialisation
    return triton.jit(_sample_kernel, do_not_specialize=["seed"])


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One 31-bit seed from the caller's generator (the default CPU
    generator when None)."""
    device = "cpu" if generator is None else generator.device
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device).item())


def fused_joint_sample(mean, log_sigma, log_alpha, temperature: float = 0.67,
                       *, generator: Optional[torch.Generator] = None):
    """[z ; y] sample, shape (B, Dc + Dd) f32, seeded from ``generator``."""
    seed = draw_seed(generator)
    if mean.device.type == "cpu":
        return fused_joint_sample_plain(
            mean, log_sigma, log_alpha, temperature,
            generator=torch.Generator().manual_seed(seed))
    b, dc = mean.shape
    dd = log_alpha.shape[1]
    tensors = (mean, log_sigma, log_alpha)
    if (any(t.dtype != torch.float32 or t.device != mean.device
            or not t.is_contiguous() for t in tensors)
            or log_sigma.shape != mean.shape or log_alpha.shape[0] != b):
        raise ValueError("fused_sample kernel takes contiguous float32 "
                         "(B, Dc), (B, Dc), (B, Dd) on one card")
    out = torch.empty((b, dc + dd), device=mean.device, dtype=torch.float32)
    grid = ((b + _BLOCK_B - 1) // _BLOCK_B,)
    with torch.cuda.device(mean.device):
        _compiled()[grid](mean, log_sigma, log_alpha, out, b, dc, dd, seed,
                          float(temperature), BLOCK_B=_BLOCK_B,
                          BLOCK_DC=max(16, 1 << (dc - 1).bit_length()),
                          BLOCK_DD=max(16, 1 << (dd - 1).bit_length()),
                          num_warps=4)
    fused_joint_sample.launches += 1
    return out


fused_joint_sample.launches = 0
