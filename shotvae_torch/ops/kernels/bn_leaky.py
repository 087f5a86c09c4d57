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

Every product and sum is rounded on its own, as in the plain versions
(Triton's ``enable_fp_fusion=False``: no FMA contraction). The backward's
activation mask is the sign of ``xhat * gamma + beta``; with an FMA, a
pre-activation within one rounding of 0 took the other sign than in the
plain version about once in 10^8 elements, and the mask flip moved a
channel's sums by a whole gradient element (measured on the card at
densenet121's shapes).

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
(``out_ref +=``); Hopper runs blocks in no order, so each reduction
(statistics, backward reduce) is one launch in two parts. Each program
walks a contiguous run of row blocks of 16 KiB of x or g each, whatever
the dtype (``reduce_plan``), keeps its sums in registers and writes one
partial row; it then draws a ticket from an int32 counter of its channel
block (``atomic_add``, acquire-release). The program that draws the last
ticket adds all partials of its channel block in program order, writes
the result (for the statistics mean, var and invstd, so the host runs no
small ops) and resets the counter to 0. The order of every sum is fixed,
only which program performs the last one varies, so one input gives one
bitstream. The counters are one buffer per card and stream (two streams'
reductions never share one), allocated on the stream's first reduction
and zero at rest, so a CUDA graph can capture the launch; a graph's
replays must not run beside eager reductions on its capture stream. The
program count is sized from the card so that the last program's tail
(its partial rows) stays short beside each program's share of the rows. The TPU-only lane
fold (``_fold_factor``), row tiling (``_tile_rows``) and padding
(``_pad_rows``) are not carried over.

Each kernel's plain version sits beside it (torch ops of the same formula);
on the CPU a wrapper runs it, on a CUDA tensor it launches the kernel or
raises. ``bn_leaky_train`` joins the four under one
``torch.autograd.Function`` returning ``(y, mean, var)``, as the
``custom_vjp`` does; the mean/var cotangents are dropped (:196). With a
process group it is sync-BN: the statistics and the backward's sums are
all-reduced between the kernels (``global_stats``, ``global_sums``), as the
JAX package's GSPMD step pools BatchNorm over the global batch.
"""

from __future__ import annotations

import functools
import math

import torch

from shotvae_torch.ops.kernels import count_launch, init_counts, sm_count
from shotvae_torch.parallel.mesh import issue

LEAKY_SLOPE = 0.01
_BLOCK_ELEMS = 4096      # elements per apply program: 16 KiB of f32
_MAX_BLOCK_C = 256
_REDUCE_BLOCK_BYTES = 16384  # bytes of x or g per reduction iteration
_REDUCE_ROW_BYTES = 256      # most bytes of a row a reduction block covers
_PROGRAMS_PER_SM = 4         # at most this many reduction programs per SM
_TAIL_ELEMS = 4096           # partial sums per iteration of the last program
_MAX_COL_BLOCKS = 1024       # channel-block counters per card
_REDUCE_WARPS = 4            # warps of a reduction program (measured)
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
                       slope: float = LEAKY_SLOPE, count=None):
    """dx = gamma * invstd * (g' - (sum g' + xhat * sum g' xhat) / M), M
    the rows the statistics were taken over (``count``; default g's)."""
    gp = _grad_through_leaky(g, xhat, gamma, beta, slope)
    inv_m = 1.0 / (count or g.shape[0])
    dx = (gamma * stats[2]) * (gp - inv_m * (sums[0] + xhat * sums[1]))
    return dx.to(g.dtype)


# ------------------------------------------------------------------ kernels


def _stats_kernel(x_ptr, part_ptr, count_ptr, out_ptr, M, C, ITERS, eps,
                  BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
                  BLOCK_P: tl.constexpr):
    """Sum and sum of squares of ITERS row blocks; the last program of the
    channel block writes [mean; var; invstd] (fused_bn_act.py:171-173)."""
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
    _finish(part_ptr, count_ptr, out_ptr, tl.sum(acc, axis=0),
            tl.sum(acc2, axis=0), M, C, eps, True, BLOCK_P, BLOCK_C)


def _bwd_reduce_kernel(g_ptr, xhat_ptr, gamma_ptr, beta_ptr, part_ptr,
                       count_ptr, out_ptr, M, C, ITERS, slope,
                       BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
                       BLOCK_P: tl.constexpr):
    """Sums of g' and g' * xhat of ITERS row blocks; the last program of the
    channel block writes the two totals."""
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
    _finish(part_ptr, count_ptr, out_ptr, tl.sum(acc, axis=0),
            tl.sum(acc2, axis=0), M, C, 0.0, False, BLOCK_P, BLOCK_C)


def _finish(part_ptr, count_ptr, out_ptr, a, b, M, C, eps,
            STATS: tl.constexpr, BLOCK_P: tl.constexpr,
            BLOCK_C: tl.constexpr):
    """Store this program's sums ``a`` and ``b`` as its row of the
    (channel blocks, P, 2, BLOCK_C) partials and draw a ticket; the program
    that draws the last one adds the P rows of its channel block in program
    order, writes [mean; var; invstd] (STATS) or the two sums, and resets
    the counter."""
    pid, blk = tl.program_id(0), tl.program_id(1)
    n_prog = tl.num_programs(0)
    lanes = tl.arange(0, BLOCK_C)
    base = part_ptr + blk * n_prog * 2 * BLOCK_C
    tl.store(base + pid * 2 * BLOCK_C + lanes, a)
    tl.store(base + pid * 2 * BLOCK_C + BLOCK_C + lanes, b)
    tl.debug_barrier()  # every thread's partials before the release
    ticket = tl.atomic_add(count_ptr + blk, 1, sem="acq_rel")
    if ticket == n_prog - 1:
        s = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        s2 = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        for p0 in range(0, n_prog, BLOCK_P):
            ps = p0 + tl.arange(0, BLOCK_P)
            mask = (ps[:, None] < n_prog) & (lanes[None, :] < BLOCK_C)
            src = base + ps[:, None] * 2 * BLOCK_C + lanes[None, :]
            s += tl.load(src, mask=mask, other=0.0, cache_modifier=".cg")
            s2 += tl.load(src + BLOCK_C, mask=mask, other=0.0,
                          cache_modifier=".cg")
        tot = tl.sum(s, axis=0)
        tot2 = tl.sum(s2, axis=0)
        cols = blk * BLOCK_C + lanes
        col_ok = cols < C
        if STATS:
            mean = tot / M
            var = tl.maximum(tot2 / M - mean * mean, 0.0)
            tl.store(out_ptr + cols, mean, mask=col_ok)
            tl.store(out_ptr + C + cols, var, mask=col_ok)
            tl.store(out_ptr + 2 * C + cols, tl.rsqrt(var + eps), mask=col_ok)
        else:
            tl.store(out_ptr + cols, tot, mask=col_ok)
            tl.store(out_ptr + C + cols, tot2, mask=col_ok)
        tl.atomic_xchg(count_ptr + blk, 0)


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
    import triton
    import triton.language

    global tl, _finish
    tl = triton.language
    _finish = triton.jit(_finish)  # called from the two reduction kernels
    return {f.__name__: triton.jit(f) for f in (
        _stats_kernel, _bwd_reduce_kernel, _apply_kernel, _bwd_apply_kernel)}


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


def reduce_plan(m: int, c: int, elem_bytes: int, num_sms: int = 132) -> dict:
    """A reduction's launch over (m, c) rows of ``elem_bytes`` elements on
    a card with ``num_sms`` SMs: a (programs, col_blocks) grid whose
    program p takes the row blocks [p * iters, (p + 1) * iters) of
    BLOCK_M x BLOCK_C = 16 KiB of data each, whatever the dtype. Every
    program reads m * elem_bytes / programs bytes per channel and the last
    one 8 * programs more (its partial rows), so about
    sqrt(m * elem_bytes / 8) programs per channel block balance the two;
    at most _PROGRAMS_PER_SM per SM."""
    block_c = min(_REDUCE_ROW_BYTES // elem_bytes,
                  max(16, 1 << (c - 1).bit_length()))
    block_m = _REDUCE_BLOCK_BYTES // (block_c * elem_bytes)
    row_blocks, col_blocks = -(-m // block_m), -(-c // block_c)
    programs = min(row_blocks,
                   max(1, _PROGRAMS_PER_SM * num_sms // col_blocks),
                   max(1, math.isqrt(m * elem_bytes // 8)))
    iters = -(-row_blocks // programs)
    return dict(block_m=block_m, block_c=block_c, row_blocks=row_blocks,
                col_blocks=col_blocks, programs=-(-row_blocks // iters),
                iters=iters, block_p=_TAIL_ELEMS // block_c)


_COUNTERS: dict = {}


def _counters(dev):
    """The channel-block counters of ``dev``'s current stream, zero at
    rest. Each stream has its own, so reductions running at once on two
    streams never draw tickets from one counter; a CUDA graph uses those of
    the stream it was captured on. They are allocated on the stream's first
    reduction, which must not be inside a capture: warm up on the capture
    stream first, as CUDA graphs ask of every kernel anyway."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _COUNTERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "bn_leaky reductions: no ticket counters for this stream "
                "yet; run one reduction on it before capturing a CUDA graph")
        _COUNTERS[key] = torch.zeros(_MAX_COL_BLOCKS, dtype=torch.int32,
                                     device=dev)
    return _COUNTERS[key]


def _reduce(kernel: str, inputs, extra, m: int, c: int, stats: bool):
    """One launch of a reduction kernel over (m, c) rows; returns its
    (3, C) statistics or (2, C) sums."""
    dev = inputs[0].device
    plan = reduce_plan(m, c, inputs[0].element_size(), sm_count(dev.index))
    if plan["col_blocks"] > _MAX_COL_BLOCKS:
        raise ValueError(f"bn_leaky reductions take at most "
                         f"{_MAX_COL_BLOCKS} channel blocks; C={c}")
    part = torch.empty((plan["col_blocks"], plan["programs"], 2,
                        plan["block_c"]), device=dev, dtype=torch.float32)
    out = torch.empty((3 if stats else 2, c), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _compiled()[kernel][(plan["programs"], plan["col_blocks"])](
            *inputs, part, _counters(dev), out, m, c, plan["iters"],
            *extra, BLOCK_M=plan["block_m"], BLOCK_C=plan["block_c"],
            BLOCK_P=plan["block_p"], num_warps=_REDUCE_WARPS,
            enable_fp_fusion=False)
    return out


def bn_stats(x, eps: float = 1e-5):
    """(M, C) rows -> (3, C) f32 [mean; biased var, clamped at 0; invstd]."""
    if x.device.type == "cpu":
        return bn_stats_plain(x, eps)
    m, c = x.shape
    _check(x, c=c)
    out = _reduce("_stats_kernel", (x,), (float(eps),), m, c, stats=True)
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
            BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4,
            enable_fp_fusion=False)
    count_launch(bn_apply, x.dtype)
    return y, xhat


def bn_bwd_reduce(g, xhat, gamma, beta, slope: float = LEAKY_SLOPE):
    """-> (2, C) f32 [sum g' (dbeta); sum g' * xhat (dgamma)]."""
    if g.device.type == "cpu":
        return bn_bwd_reduce_plain(g, xhat, gamma, beta, slope)
    m, c = g.shape
    _check(g, xhat, gamma, beta, c=c)
    out = _reduce("_bwd_reduce_kernel", (g, xhat, gamma, beta),
                  (float(slope),), m, c, stats=False)
    count_launch(bn_bwd_reduce, g.dtype)
    return out


def bn_bwd_apply(g, xhat, gamma, beta, stats, sums,
                 slope: float = LEAKY_SLOPE, count=None):
    """dx of the (M, C) rows, in g's dtype, from ``bn_stats``'s and
    ``bn_bwd_reduce``'s outputs; ``count``: the rows the statistics and
    sums were taken over, where they span more than g's (sync-BN)."""
    if g.device.type == "cpu":
        return bn_bwd_apply_plain(g, xhat, gamma, beta, stats, sums, slope,
                                  count)
    m, c = g.shape
    _check(g, xhat, gamma, beta, stats, sums, c=c)
    dx = torch.empty_like(g)
    block_m, block_c, row_blocks, col_blocks = _blocks(m, c)
    with torch.cuda.device(g.device):
        _compiled()["_bwd_apply_kernel"][(row_blocks, col_blocks)](
            g, xhat, gamma, beta, stats, sums, dx, m, c, 1.0 / (count or m),
            float(slope), BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4,
            enable_fp_fusion=False)
    count_launch(bn_bwd_apply, g.dtype)
    return dx


init_counts(bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_apply)


# ------------------------------------------------------------------ sync-BN
# Neither collective reads a value back to the host (the world size is the
# group's own host-side count), so a CUDA graph captures each all-reduce
# between the kernels, as ``train.chunk`` does over a process group.


def global_stats(stats, m: int, eps: float, group):
    """Sync-BN's forward collective: from this rank's ``bn_stats`` of its
    ``m`` rows, the (3, C) [mean; biased var, clamped at 0; invstd] of the
    rows of every rank of ``group`` (each with ``m`` rows), and their
    count. One all-reduce of the per-channel sums [m * mean; m * (var +
    mean^2)] in float64; mean and var then in float64, rounded to float32,
    and invstd from the float32 var as the kernel takes it."""
    local = stats[:2].to(torch.float64)
    sums = torch.stack([local[0], local[1] + local[0] * local[0]]) * m
    issue(torch.distributed.all_reduce, sums, group)
    count = m * torch.distributed.get_world_size(group)
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0).to(torch.float32)
    return torch.stack([mean.to(torch.float32), var,
                        torch.rsqrt(var + eps)]), count


def global_sums(sums, group):
    """Sync-BN's backward collective: ``bn_bwd_reduce``'s (2, C) sums over
    the rows of every rank of ``group``."""
    total = sums.clone()
    issue(torch.distributed.all_reduce, total, group)
    return total


# ------------------------------------------------------------------ autograd


class _BnLeakyTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope, group):
        stats, count = bn_stats(x, eps), None
        if group is not None:
            stats, count = global_stats(stats, x.shape[0], eps, group)
        y, xhat = bn_apply(x, stats, gamma, beta, slope)
        ctx.save_for_backward(xhat, stats, gamma, beta)
        ctx.slope, ctx.group, ctx.count = slope, group, count
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        xhat, stats, gamma, beta = ctx.saved_tensors
        g = g.contiguous()
        sums = bn_bwd_reduce(g, xhat, gamma, beta, ctx.slope)
        total = sums if ctx.group is None else global_sums(sums, ctx.group)
        dx = bn_bwd_apply(g, xhat, gamma, beta, stats, total, ctx.slope,
                          ctx.count)
        # dgamma and dbeta of this rank's rows: the gradient mean over the
        # ranks makes them the global batch's
        return dx, sums[1], sums[0], None, None, None


def bn_leaky_train(x, gamma, beta, eps: float = 1e-5,
                   slope: float = LEAKY_SLOPE, group=None):
    """Training-mode BN + LeakyReLU(slope) on (M, C) rows -> (y, mean, var),
    the biased batch statistics that feed the running-stat update; slope 0
    is the decoder's ReLU. Differentiable in x, gamma and beta.

    ``group``: a process group whose ranks each hold M rows of one global
    batch (sync-BN). The statistics are then the global batch's (one
    all-reduce after the statistics kernel), and so is the backward's
    normalisation (one all-reduce after the backward reduce kernel); the
    gradients of gamma and beta stay this rank's own, which the gradient
    mean over the ranks makes the global batch's."""
    return _BnLeakyTrain.apply(x, gamma, beta, eps, slope, group)
