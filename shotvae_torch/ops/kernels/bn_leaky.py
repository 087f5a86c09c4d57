"""Training-mode BatchNorm + LeakyReLU, as four Triton kernels.

Replaces ``bn_leaky_train`` (shotvae_tpu/ops/pallas/fused_bn_act.py:149-229)
and its four ``pallas_call``s, over (M, C) rows with biased batch
statistics in f32:

* ``bn_stats`` (``_stats_kernel`` :71, called at :140): per-channel sum and
  sum of squares; mean, biased var (clamped at 0) and invstd as at :169-173;
* ``bn_apply`` (``_apply_kernel`` :84, called at :176):
  ``xhat = (x - mean) * invstd``, ``y = leaky(xhat * gamma + beta)``; it
  writes y and the f32 xhat that the backward reads (:188-192);
* ``bn_bwd_reduce`` (``_bwd_reduce_kernel`` :96, called at :206): the sums
  of ``g' = g * leaky'(pre)`` and ``g' * xhat``, which are dbeta and dgamma;
* ``bn_bwd_apply`` (``_bwd_apply_kernel`` :111, called at :217):
  ``dx = gamma * invstd * (g' - (sum g' + xhat * sum g' xhat) / M)``.

Data types, as the TPU kernels write them (fused_bn_act.py:145, 182-183,
212, 223): x and y, and g and dx, are float32 or bfloat16 (the bf16 trunk);
the statistics, xhat and the sums are always float32. A kernel loads bf16,
computes in f32 and stores with a round-to-nearest-even cast (Triton's
default for a float downcast). Triton compiles a variant per pointer type,
so the bf16 kernels are separate launches, counted on ``launches_bf16``.

What bounds them on the H100: memory. Each is one or two passes over (M, C)
rows with a handful of flops per element, far below the card's
operations-per-byte line; the least times are 4, 12, 8 and 12 bytes per
element over 3.35 TB/s in f32, and 2, 8, 6 and 8 with bf16 x/y/g/dx.

Design. A program owns a block of rows by a power-of-two block of channels
(masked where C is not a multiple of it), the pattern of ``bn_act.py``. The
TPU kernels carried their sums across sequential grid steps
(``out_ref +=``); Hopper runs blocks in no order, so each reduction program
walks a contiguous run of row blocks, keeps its sums in registers and
writes one partial row; a finishing launch, one program per 16 channels,
adds the partials in a fixed order, so one input gives one bitstream (no
atomics), and, for the
statistics, forms mean, var and invstd on the card so that the host runs no
small ops. The TPU-only lane fold (``_fold_factor``), row tiling
(``_tile_rows``) and padding (``_pad_rows``) are not carried over.

Each kernel's plain version sits beside it (torch ops of the same formula);
on the CPU a wrapper runs it, on a CUDA tensor it launches the kernel or
raises. ``bn_leaky_train`` joins the four under one
``torch.autograd.Function`` returning ``(y, mean, var)``, as the
``custom_vjp`` does; the mean/var cotangents are dropped (:196).
"""

from __future__ import annotations

import functools

import torch

from shotvae_torch.ops.kernels import count_launch, init_counts

LEAKY_SLOPE = 0.01
_BLOCK_ELEMS = 4096      # elements per program and row block: 16 KiB of f32
_MAX_BLOCK_C = 256
_REDUCE_PROGRAMS = 1056  # 8 per SM of the H100's 132: enough to fill the card
_FINISH_BLOCK_C = 16     # channels per finishing program: C / 16 of them
tl = None  # triton.language, bound by _compiled() on the first launch


# ------------------------------------------------------------ plain versions


def bn_stats_plain(x, eps: float = 1e-5):
    """(M, C) -> (3, C) f32 rows [mean; biased var, clamped at 0; invstd]."""
    x = x.to(torch.float32)
    m = x.shape[0]
    mean = x.sum(0) / m
    var = torch.clamp((x * x).sum(0) / m - mean * mean, min=0.0)
    return torch.stack([mean, var, torch.rsqrt(var + eps)])


def bn_apply_plain(x, stats, gamma, beta, slope: float = LEAKY_SLOPE):
    """-> (y, xhat): xhat = (x - mean) * invstd, y = leaky(xhat*gamma + beta)."""
    xhat = (x.to(torch.float32) - stats[0]) * stats[2]
    y = xhat * gamma + beta
    return torch.where(y >= 0, y, slope * y).to(x.dtype), xhat


def _grad_through_leaky(g, xhat, gamma, beta, slope):
    pre = xhat * gamma + beta
    return g.to(torch.float32) * torch.where(pre >= 0, 1.0, slope)


def bn_bwd_reduce_plain(g, xhat, gamma, beta, slope: float = LEAKY_SLOPE):
    """-> (2, C) f32 rows [sum g' (dbeta); sum g' * xhat (dgamma)]."""
    gp = _grad_through_leaky(g, xhat, gamma, beta, slope)
    return torch.stack([gp.sum(0), (gp * xhat).sum(0)])


def bn_bwd_apply_plain(g, xhat, gamma, beta, stats, sums,
                       slope: float = LEAKY_SLOPE):
    """dx = gamma * invstd * (g' - (sum g' + xhat * sum g' xhat) / M)."""
    gp = _grad_through_leaky(g, xhat, gamma, beta, slope)
    inv_m = 1.0 / g.shape[0]
    dx = (gamma * stats[2]) * (gp - inv_m * (sums[0] + xhat * sums[1]))
    return dx.to(g.dtype)


# ------------------------------------------------------------------ kernels


def _stats_kernel(x_ptr, part_ptr, M, C, ITERS, BLOCK_M: tl.constexpr,
                  BLOCK_C: tl.constexpr):
    """Partial sum and sum of squares of ITERS row blocks -> part[pid_m]."""
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    acc = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
    for i in range(ITERS):
        rows = ((tl.program_id(0) * ITERS + i) * BLOCK_M
                + tl.arange(0, BLOCK_M))
        mask = (rows[:, None] < M) & col_ok[None, :]
        x = tl.load(x_ptr + rows[:, None].to(tl.int64) * C + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        acc += x
        acc2 += x * x
    out = part_ptr + tl.program_id(0) * 2 * C + cols
    tl.store(out, tl.sum(acc, axis=0), mask=col_ok)
    tl.store(out + C, tl.sum(acc2, axis=0), mask=col_ok)


def _bwd_reduce_kernel(g_ptr, xhat_ptr, gamma_ptr, beta_ptr, part_ptr, M, C,
                       ITERS, slope, BLOCK_M: tl.constexpr,
                       BLOCK_C: tl.constexpr):
    """Partial sums of g' and g' * xhat of ITERS row blocks -> part[pid_m]."""
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    gamma = tl.load(gamma_ptr + cols, mask=col_ok, other=0.0)
    beta = tl.load(beta_ptr + cols, mask=col_ok, other=0.0)
    acc = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
    for i in range(ITERS):
        rows = ((tl.program_id(0) * ITERS + i) * BLOCK_M
                + tl.arange(0, BLOCK_M))
        mask = (rows[:, None] < M) & col_ok[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = tl.load(xhat_ptr + offs, mask=mask, other=0.0)
        pre = xhat * gamma[None, :] + beta[None, :]
        gp = g * tl.where(pre >= 0, 1.0, slope)
        acc += gp
        acc2 += gp * xhat
    out = part_ptr + tl.program_id(0) * 2 * C + cols
    tl.store(out, tl.sum(acc, axis=0), mask=col_ok)
    tl.store(out + C, tl.sum(acc2, axis=0), mask=col_ok)


def _finish_kernel(part_ptr, out_ptr, P, M, C, eps, STATS: tl.constexpr,
                   BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Add the (P, 2, C) partials in order. STATS: write [mean; var; invstd]
    (fused_bn_act.py:171-173), else the two sums."""
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    s = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    s2 = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        ps = p0 + tl.arange(0, BLOCK_P)
        mask = (ps[:, None] < P) & col_ok[None, :]
        src = part_ptr + ps[:, None] * 2 * C + cols[None, :]
        s += tl.load(src, mask=mask, other=0.0)
        s2 += tl.load(src + C, mask=mask, other=0.0)
    a = tl.sum(s, axis=0)
    b = tl.sum(s2, axis=0)
    if STATS:
        mean = a / M
        var = tl.maximum(b / M - mean * mean, 0.0)
        tl.store(out_ptr + cols, mean, mask=col_ok)
        tl.store(out_ptr + C + cols, var, mask=col_ok)
        tl.store(out_ptr + 2 * C + cols, tl.rsqrt(var + eps), mask=col_ok)
    else:
        tl.store(out_ptr + cols, a, mask=col_ok)
        tl.store(out_ptr + C + cols, b, mask=col_ok)


def _apply_kernel(x_ptr, stats_ptr, gamma_ptr, beta_ptr, y_ptr, xhat_ptr, M,
                  C, slope, BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    mask = (rows[:, None] < M) & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * C + cols[None, :]
    mean = tl.load(stats_ptr + cols, mask=col_ok, other=0.0)
    invstd = tl.load(stats_ptr + 2 * C + cols, mask=col_ok, other=0.0)
    gamma = tl.load(gamma_ptr + cols, mask=col_ok, other=0.0)
    beta = tl.load(beta_ptr + cols, mask=col_ok, other=0.0)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    xhat = (x - mean[None, :]) * invstd[None, :]
    y = xhat * gamma[None, :] + beta[None, :]
    y = tl.where(y >= 0, y, slope * y)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
    tl.store(xhat_ptr + offs, xhat, mask=mask)


def _bwd_apply_kernel(g_ptr, xhat_ptr, gamma_ptr, beta_ptr, stats_ptr,
                      sums_ptr, dx_ptr, M, C, inv_m, slope,
                      BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    mask = (rows[:, None] < M) & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * C + cols[None, :]
    gamma = tl.load(gamma_ptr + cols, mask=col_ok, other=0.0)
    beta = tl.load(beta_ptr + cols, mask=col_ok, other=0.0)
    invstd = tl.load(stats_ptr + 2 * C + cols, mask=col_ok, other=0.0)
    sum_gp = tl.load(sums_ptr + cols, mask=col_ok, other=0.0)
    sum_gpx = tl.load(sums_ptr + C + cols, mask=col_ok, other=0.0)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    xhat = tl.load(xhat_ptr + offs, mask=mask, other=0.0)
    pre = xhat * gamma[None, :] + beta[None, :]
    gp = g * tl.where(pre >= 0, 1.0, slope)
    dx = (gamma * invstd)[None, :] * (
        gp - inv_m * (sum_gp[None, :] + xhat * sum_gpx[None, :]))
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _compiled():
    """Import Triton and wrap the kernels on first use: importing this
    module must work where Triton is not installed."""
    global tl
    import triton
    import triton.language

    tl = triton.language
    return {f.__name__: triton.jit(f) for f in (
        _stats_kernel, _bwd_reduce_kernel, _finish_kernel, _apply_kernel,
        _bwd_apply_kernel)}


# ----------------------------------------------------------------- wrappers


def _blocks(m: int, c: int):
    """(BLOCK_M, BLOCK_C, row blocks, channel blocks)."""
    block_c = min(_MAX_BLOCK_C, max(16, 1 << (c - 1).bit_length()))
    block_m = _BLOCK_ELEMS // block_c
    return block_m, block_c, -(-m // block_m), -(-c // block_c)


def _check(data, *f32, c: int):
    """Kernel arguments: contiguous, on one card, C channels last; ``data``
    (x or g) float32 or bfloat16, the rest (xhat, statistics, sums,
    gamma, beta) float32."""
    for t in (data, *f32):
        ok = ((torch.float32, torch.bfloat16) if t is data
              else (torch.float32,))
        if (t.dtype not in ok or t.device != data.device
                or not t.is_contiguous() or t.shape[-1] != c):
            raise ValueError(
                f"bn_leaky kernels take contiguous float32 or bfloat16 (M, C) "
                f"rows with float32 xhat and (C,) vectors on one card, C={c}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} contiguous="
                f"{t.is_contiguous()}")


def _reduce(kernel: str, inputs, extra, m: int, c: int, eps: float,
            stats: bool):
    """Launch a partial-sum kernel over (m, c) rows, then the finishing
    kernel; returns its (3, C) statistics or (2, C) sums."""
    dev = inputs[0].device
    block_m, block_c, row_blocks, col_blocks = _blocks(m, c)
    programs = min(row_blocks, max(1, _REDUCE_PROGRAMS // col_blocks))
    iters = -(-row_blocks // programs)
    programs = -(-row_blocks // iters)
    part = torch.empty((programs, 2, c), device=dev, dtype=torch.float32)
    out = torch.empty((3 if stats else 2, c), device=dev, dtype=torch.float32)
    k = _compiled()
    with torch.cuda.device(dev):
        k[kernel][(programs, col_blocks)](*inputs, part, m, c, iters, *extra,
                                          BLOCK_M=block_m, BLOCK_C=block_c,
                                          num_warps=8)
        k["_finish_kernel"][(-(-c // _FINISH_BLOCK_C),)](
            part, out, programs, m, c, float(eps), STATS=stats,
            BLOCK_P=_BLOCK_ELEMS // _FINISH_BLOCK_C,
            BLOCK_C=_FINISH_BLOCK_C, num_warps=8)
    return out


def bn_stats(x, eps: float = 1e-5):
    """(M, C) rows -> (3, C) f32 [mean; biased var, clamped at 0; invstd]."""
    if x.device.type == "cpu":
        return bn_stats_plain(x, eps)
    m, c = x.shape
    _check(x, c=c)
    out = _reduce("_stats_kernel", (x,), (), m, c, eps, stats=True)
    count_launch(bn_stats, x.dtype)
    return out


def bn_apply(x, stats, gamma, beta, slope: float = LEAKY_SLOPE):
    """-> (y, xhat) from (M, C) rows and ``bn_stats``'s (3, C) output; y in
    x's dtype, xhat float32."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, stats, gamma, beta, slope)
    m, c = x.shape
    _check(x, stats, gamma, beta, c=c)
    y = torch.empty_like(x)
    xhat = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    block_m, block_c, row_blocks, col_blocks = _blocks(m, c)
    with torch.cuda.device(x.device):
        _compiled()["_apply_kernel"][(row_blocks, col_blocks)](
            x, stats, gamma, beta, y, xhat, m, c, float(slope),
            BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    count_launch(bn_apply, x.dtype)
    return y, xhat


def bn_bwd_reduce(g, xhat, gamma, beta, slope: float = LEAKY_SLOPE):
    """-> (2, C) f32 [sum g' (dbeta); sum g' * xhat (dgamma)]."""
    if g.device.type == "cpu":
        return bn_bwd_reduce_plain(g, xhat, gamma, beta, slope)
    m, c = g.shape
    _check(g, xhat, gamma, beta, c=c)
    out = _reduce("_bwd_reduce_kernel", (g, xhat, gamma, beta),
                  (float(slope),), m, c, 0.0, stats=False)
    count_launch(bn_bwd_reduce, g.dtype)
    return out


def bn_bwd_apply(g, xhat, gamma, beta, stats, sums,
                 slope: float = LEAKY_SLOPE):
    """dx of the (M, C) rows, in g's dtype, from ``bn_stats``'s and
    ``bn_bwd_reduce``'s outputs."""
    if g.device.type == "cpu":
        return bn_bwd_apply_plain(g, xhat, gamma, beta, stats, sums, slope)
    m, c = g.shape
    _check(g, xhat, gamma, beta, stats, sums, c=c)
    dx = torch.empty_like(g)
    block_m, block_c, row_blocks, col_blocks = _blocks(m, c)
    with torch.cuda.device(g.device):
        _compiled()["_bwd_apply_kernel"][(row_blocks, col_blocks)](
            g, xhat, gamma, beta, stats, sums, dx, m, c, 1.0 / m,
            float(slope), BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    count_launch(bn_bwd_apply, g.dtype)
    return dx


init_counts(bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_apply)


# ------------------------------------------------------------------ autograd


class _BnLeakyTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        stats = bn_stats(x, eps)
        y, xhat = bn_apply(x, stats, gamma, beta, slope)
        ctx.save_for_backward(xhat, stats, gamma, beta)
        ctx.slope = slope
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        xhat, stats, gamma, beta = ctx.saved_tensors
        g = g.contiguous()
        sums = bn_bwd_reduce(g, xhat, gamma, beta, ctx.slope)
        dx = bn_bwd_apply(g, xhat, gamma, beta, stats, sums, ctx.slope)
        return dx, sums[1], sums[0], None, None


def bn_leaky_train(x, gamma, beta, eps: float = 1e-5,
                   slope: float = LEAKY_SLOPE):
    """Training-mode BN + LeakyReLU(slope) on (M, C) rows -> (y, mean, var),
    the biased batch statistics that feed the running-stat update; slope 0
    is the decoder's ReLU. Differentiable in x, gamma and beta."""
    return _BnLeakyTrain.apply(x, gamma, beta, eps, slope)
