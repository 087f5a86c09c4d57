"""Fused BN affine + LeakyReLU + 3x3 conv (forward), as CUDA C++ kernels.

Replaces the forward of ``fused_bn_act_conv``
(shotvae_tpu/ops/pallas/fused_conv.py:230, kernel ``_kernel`` :101):
``conv3x3_SAME(leaky(x * scale + shift), w)``, stride 1, with the
activated tensor never written to device memory. Two kernels, by x's
dtype, each counted on its own counter:

* float32: ``shotvae_torch/csrc/fused_conv.cu``, a direct conv on the CUDA
  cores (``fused_bn_act_conv.launches``);
* bfloat16: ``shotvae_torch/csrc/fused_conv_bf16.cu``, an implicit GEMM on
  the tensor cores (``fused_bn_act_conv.launches_bf16``). As the TPU kernel
  does in bf16, the activation is computed in f32 and rounded to bf16 before
  the product (fused_conv.py:115), the weight is cast to bf16 (:167), the
  sums are f32 and y is bf16.

Each source's header says what bounds it on the H100 and how its design
answers that. The TPU kernel's batch-tile sizing (``_pick_tile``) and
flat-row shift-and-mask layout are not carried over.

Tensors are NCHW in ``channels_last`` memory format, so the kernel sees the
NHWC rows the TPU kernel saw; the (Cout, Cin, 3, 3) weight is reordered once
per call into the (9*Cin, Cout) matrix the kernel reads.

Two differentiable sites launch the kernel:

* ``fused_bn_act_conv(x, scale, shift, w)``, the eval-mode site (running
  statistics folded into scale/shift), carries the JAX VJP of
  ``(x, scale, shift, w)`` (``_fused_bwd``, fused_conv.py:215-224): the
  activation is recomputed from x, and dgrad/wgrad come from the library
  (cuDNN), as JAX leaves them to XLA.
* ``fused_bn_act_conv_train(x, gamma, beta, w)``, the train-mode site:
  BN with batch statistics -> LeakyReLU -> conv, returning
  ``(y, mean, var)``. Forward: the ``bn_leaky`` statistics kernel, the fold,
  then the fused conv kernel, so the activated tensor never reaches device
  memory. Backward: the ``bn_leaky`` apply kernel recomputes the activation
  and xhat, cuDNN gives d(act) and dw, and the two ``bn_leaky`` backward
  kernels turn d(act) into dx, dgamma and dbeta: exactly the gradient of
  ``conv(leaky(BN_train(x)))``.

Both sites cast the weight to x's dtype on every call, as the JAX kernel
does, so an f32 master weight gets its gradient through the cast. On the
CPU the wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from shotvae_torch.ops.kernels import _build, count_launch, init_counts
from shotvae_torch.ops.kernels.bn_leaky import (bn_apply, bn_bwd_apply,
                                                bn_bwd_reduce, bn_stats)

LEAKY_SLOPE = 0.01


def bn_affine_from_stats(mean, var, gamma, beta, eps: float = 1e-5):
    """Fold BatchNorm statistics and the learned affine into f32
    (scale, shift) (fused_conv.py:244-248)."""
    scale = (gamma * torch.rsqrt(var + eps)).to(torch.float32)
    return scale, (beta - mean * scale).to(torch.float32)


def to_rows(x):
    """(B, C, H, W) -> its (B*H*W, C) rows: a view of a channels_last
    tensor."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def from_rows(rows, b: int, h: int, w: int):
    """(B*H*W, C) rows -> (B, C, H, W) in channels_last format (a view)."""
    return rows.reshape(b, h, w, rows.shape[1]).permute(0, 3, 1, 2)


def fused_bn_act_conv_plain(x, scale, shift, weight, *,
                            slope: float = LEAKY_SLOPE):
    """The plain version: the activated tensor is materialised in x's dtype,
    then ``F.conv2d`` with the weight in x's dtype (fused_conv.py:197-203).
    x (B, Cin, H, W); weight (Cout, Cin, 3, 3)."""
    pre = x.to(torch.float32) * scale[:, None, None] + shift[:, None, None]
    act = torch.where(pre > 0, pre, slope * pre).to(x.dtype)
    return F.conv2d(act, weight.to(x.dtype), padding=1)


# x's dtype -> (CUDA source, C entry point, channel multiple it needs)
_KERNELS = {torch.float32: ("fused_conv", "fused_bn_act_conv3x3_f32", 4),
            torch.bfloat16: ("fused_conv_bf16", "fused_bn_act_conv3x3_bf16",
                             8)}


def _lib(dtype):
    source, entry, _ = _KERNELS[dtype]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _fused_conv_forward(x, scale, shift, weight, slope: float):
    """The kernels' wrapper (no autograd): x (B, Cin, H, W), channels_last
    on the card, float32 or bfloat16; weight (Cout, Cin, 3, 3) in x's dtype;
    scale/shift (Cin,) f32. Returns y in x's dtype."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f"expected a (Cout, {cin}, 3, 3) weight, got "
                         f"{tuple(weight.shape)}")
    if x.device.type == "cpu":
        return fused_bn_act_conv_plain(x, scale, shift, weight, slope=slope)
    if (x.dtype not in _KERNELS or weight.dtype != x.dtype
            or scale.dtype != torch.float32 or shift.dtype != torch.float32
            or any(t.device != x.device for t in (scale, shift, weight))):
        raise ValueError(f"fused_conv kernels take x and the weight both "
                         f"float32 or both bfloat16, and float32 scale/shift, "
                         f"on one card; got x {x.dtype}, weight "
                         f"{weight.dtype}, scale {scale.dtype}, shift "
                         f"{shift.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_conv kernel takes x in channels_last format")
    mult = _KERNELS[x.dtype][2]
    if (cin % mult or cout % mult or scale.shape != (cin,)
            or shift.shape != (cin,)):
        raise ValueError(f"fused_conv {x.dtype} kernel needs Cin and Cout "
                         f"multiples of {mult} and (Cin,) scale/shift; got "
                         f"Cin={cin}, Cout={cout}, {tuple(scale.shape)}/"
                         f"{tuple(shift.shape)}")
    w2 = weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    if any(t.data_ptr() % 16 for t in (x, scale, shift, w2, y)):
        raise ValueError("fused_conv kernel needs 16-byte aligned tensors")
    err = _lib(x.dtype)(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                        w2.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
                        slope, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed: CUDA error {err}")
    count_launch(fused_bn_act_conv, x.dtype)
    return y


def _conv_grads(g, act, weight):
    """The library's dgrad and wgrad of the 3x3 SAME conv of ``act``:
    (d act, d weight)."""
    dact, dw, _ = torch.ops.aten.convolution_backward(
        g.contiguous(memory_format=torch.channels_last), act, weight, None,
        (1, 1), (1, 1), (1, 1), False, (0, 0), 1, (True, True, False))
    return dact, dw


class _FusedBnActConv(torch.autograd.Function):
    """The eval-mode site; backward as ``_fused_bwd`` (fused_conv.py:215):
    the VJP of ``_reference_composition`` (:197-203), whose activation is
    rounded to x's dtype before the conv and whose dx is cast back to it."""

    @staticmethod
    def forward(ctx, x, scale, shift, weight, slope):
        ctx.save_for_backward(x, scale, shift, weight)
        ctx.slope = slope
        return _fused_conv_forward(x, scale, shift, weight, slope)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, weight = ctx.saved_tensors
        x32 = x.to(torch.float32)
        pre = x32 * scale[:, None, None] + shift[:, None, None]
        positive = pre > 0
        act = torch.where(positive, pre, ctx.slope * pre).to(x.dtype)
        dact, dw = _conv_grads(g, act, weight)
        gp = dact.to(torch.float32) * torch.where(positive, 1.0, ctx.slope)
        return ((gp * scale[:, None, None]).to(x.dtype),
                (gp * x32).sum((0, 2, 3)), gp.sum((0, 2, 3)), dw, None)


def fused_bn_act_conv(x, scale, shift, weight, *, slope: float = LEAKY_SLOPE):
    """``conv3x3_SAME(leaky(x * scale + shift), weight)``, stride 1.

    x: (B, Cin, H, W), float32 or bfloat16, channels_last on the card;
    scale/shift: (Cin,) f32; weight: (Cout, Cin, 3, 3), cast to x's dtype.
    Returns (B, Cout, H, W) in x's dtype and channels_last. Differentiable
    in all four, with the JAX VJP.
    """
    return _FusedBnActConv.apply(x, scale, shift, weight.to(x.dtype), slope)


init_counts(fused_bn_act_conv)


class _FusedBnActConvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, weight, eps, slope):
        b, _, h, w = x.shape
        rows = to_rows(x)
        stats = bn_stats(rows, eps)
        scale = gamma * stats[2]
        shift = beta - stats[0] * scale
        y = _fused_conv_forward(from_rows(rows, b, h, w), scale, shift,
                                weight, slope)
        ctx.save_for_backward(rows, stats, gamma, beta, weight)
        ctx.dims, ctx.slope = (b, h, w), slope
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        rows, stats, gamma, beta, weight = ctx.saved_tensors
        b, h, w = ctx.dims
        act, xhat = bn_apply(rows, stats, gamma, beta, ctx.slope)
        dact, dw = _conv_grads(g, from_rows(act, b, h, w), weight)
        drows = to_rows(dact.contiguous(memory_format=torch.channels_last))
        sums = bn_bwd_reduce(drows, xhat, gamma, beta, ctx.slope)
        dx = bn_bwd_apply(drows, xhat, gamma, beta, stats, sums, ctx.slope)
        return from_rows(dx, b, h, w), sums[1], sums[0], dw, None, None


def fused_bn_act_conv_train(x, gamma, beta, weight, *, eps: float = 1e-5,
                            slope: float = LEAKY_SLOPE):
    """``conv3x3_SAME(leaky(BN_train(x)), weight)`` -> (y, mean, var), with
    the biased f32 batch statistics of x (B, Cin, H, W) that feed the
    running-stat update; y and the gradient of x in x's dtype (float32 or
    bfloat16), the weight cast to it. Differentiable in x, gamma, beta and
    weight."""
    return _FusedBnActConvTrain.apply(x, gamma, beta, weight.to(x.dtype), eps,
                                      slope)


def fused_bn_act_conv_train_plain(x, gamma, beta, weight, *,
                                  eps: float = 1e-5,
                                  slope: float = LEAKY_SLOPE):
    """The train-mode site as plain differentiable torch ops, for comparing
    values and gradients with the kernels: statistics and BN in f32, the
    activation rounded to x's dtype, the conv in x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean((0, 2, 3))
    var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
    xhat = (x32 - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    pre = xhat * gamma[:, None, None] + beta[:, None, None]
    act = torch.where(pre >= 0, pre, slope * pre).to(x.dtype)
    return F.conv2d(act, weight.to(x.dtype), padding=1), mean, var
