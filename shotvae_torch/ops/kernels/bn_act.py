"""Eval-mode BatchNorm + LeakyReLU in one pass, as a Triton kernel.

Replaces ``bn_act_inference`` (shotvae_tpu/ops/pallas/fused_bn_act.py:249,
kernel ``_inference_kernel`` :244): ``y = leaky(x * scale[c] + shift[c])``
over (M, C) rows, scale/shift folded from the running statistics inside
the kernel, so one launch is the whole function.

x and y are float32 or bfloat16 (the bf16 trunk's eval step), the BN
vectors float32; the kernel computes in f32 and rounds y to x's dtype
(fused_bn_act.py:245-246, 266). The bf16 variant is a separate launch,
counted on ``launches_bf16``.

What bounds it on the H100: memory. Per element it reads and writes one
value (4 + 4 bytes in f32, 2 + 2 in bf16) for two flops and a select, far
below the card's operations-per-byte line, so the least time is those bytes
over 3.35 TB/s.
The design does that one read and one write and nothing else: a program
owns a block of rows by a power-of-two block of channels (masked where C
is not a multiple of it), folds its channels' scale/shift once from the
four BN vectors, and streams the block. The TPU kernel's lane fold (``_fold_factor``) and VMEM
row tiling exist for the TPU's 128-lane vectors and are not carried over.

On the CPU the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. Like the JAX kernel it has no gradient: under grad
mode, an input that requires grad raises (training runs ``bn_leaky``).
"""

from __future__ import annotations

import functools

import torch

from shotvae_torch.ops.kernels import count_launch, init_counts, refuse_grad
from shotvae_torch.ops.kernels.fused_conv import bn_affine_from_stats

LEAKY_SLOPE = 0.01
_BLOCK_ELEMS = 4096  # elements per program: 16 KiB of f32 in, 16 KiB out
tl = None  # triton.language, bound by _compiled() on the first launch


def bn_act_plain(x, weight, bias, running_mean, running_var,
                 eps: float = 1e-5, slope: float = LEAKY_SLOPE):
    """The plain version: x (M, C); the BN vectors (C,)."""
    scale, shift = bn_affine_from_stats(running_mean, running_var, weight,
                                        bias, eps)
    y = x.to(torch.float32) * scale + shift
    return torch.where(y >= 0, y, slope * y).to(x.dtype)


def _bn_act_kernel(x_ptr, w_ptr, b_ptr, mean_ptr, var_ptr, y_ptr, M, C, eps,
                   slope, BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    mask = (rows[:, None] < M) & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * C + cols[None, :]
    var = tl.load(var_ptr + cols, mask=col_ok, other=1.0)
    scale = tl.load(w_ptr + cols, mask=col_ok, other=0.0) * tl.rsqrt(var + eps)
    shift = (tl.load(b_ptr + cols, mask=col_ok, other=0.0)
             - tl.load(mean_ptr + cols, mask=col_ok, other=0.0) * scale)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * scale[None, :] + shift[None, :]
    y = tl.where(y >= 0, y, slope * y)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _compiled():
    """Import Triton and wrap the kernel on first use: importing this module
    must work where Triton is not installed."""
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_bn_act_kernel)


def bn_act_inference(x, weight, bias, running_mean, running_var,
                     eps: float = 1e-5, slope: float = LEAKY_SLOPE):
    """Eval-mode BN + LeakyReLU(slope) on (M, C) rows, the running
    statistics folded to one per-channel scale/shift as
    fused_bn_act.py:252-254 does (slope 0 is the decoder's ReLU). It has
    no gradient: an input that requires grad under grad mode raises."""
    refuse_grad("bn_act_inference", "train mode (model.train(): "
                "shotvae_torch.ops.kernels.bn_leaky.bn_leaky_train)",
                x, weight, bias, running_mean, running_var)
    if x.device.type == "cpu":
        return bn_act_plain(x, weight, bias, running_mean, running_var, eps,
                            slope)
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2
            or not x.is_contiguous()):
        raise ValueError(f"bn_act kernel takes contiguous 2-D float32 or "
                         f"bfloat16 rows, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    m, c = x.shape
    vecs = (weight, bias, running_mean, running_var)
    if any(v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device
           or not v.is_contiguous() for v in vecs):
        raise ValueError(f"BN vectors must be contiguous float32 ({c},) on "
                         f"{x.device}")
    y = torch.empty_like(x)
    block_c = min(256, 1 << (c - 1).bit_length())
    block_m = _BLOCK_ELEMS // block_c
    grid = ((m + block_m - 1) // block_m, (c + block_c - 1) // block_c)
    with torch.cuda.device(x.device):
        _compiled()[grid](x, *vecs, y, m, c, float(eps), float(slope),
                          BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    count_launch(bn_act_inference, x.dtype)
    return y


init_counts(bn_act_inference)
