"""Fused BN affine + LeakyReLU + 3x3 conv (forward), as a CUDA C++ kernel.

Replaces the forward of ``fused_bn_act_conv``
(shotvae_tpu/ops/pallas/fused_conv.py:230, kernel ``_kernel`` :101):
``conv3x3_SAME(leaky(x * scale + shift), w)``, stride 1, with the
activated tensor never written to device memory. The kernel is
``shotvae_torch/csrc/fused_conv.cu``; its header says what bounds it on the
H100 (operations: f32 FMAs) and how its design answers that. The TPU
kernel's batch-tile sizing (``_pick_tile``) and flat-row shift-and-mask
layout are not carried over.

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

On the CPU the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from shotvae_torch.ops.kernels import _build
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
    """The plain version: the activated tensor is materialised, then
    ``F.conv2d``. x (B, Cin, H, W); weight (Cout, Cin, 3, 3)."""
    pre = x.to(torch.float32) * scale[:, None, None] + shift[:, None, None]
    act = torch.where(pre > 0, pre, slope * pre).to(x.dtype)
    return F.conv2d(act, weight.to(x.dtype), padding=1)


def _lib():
    lib = _build.load("fused_conv")
    fn = lib.fused_bn_act_conv3x3_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _fused_conv_forward(x, scale, shift, weight, slope: float):
    """The kernel's wrapper (no autograd): x (B, Cin, H, W), channels_last
    on the card; scale/shift (Cin,) f32; weight (Cout, Cin, 3, 3)."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f"expected a (Cout, {cin}, 3, 3) weight, got "
                         f"{tuple(weight.shape)}")
    if x.device.type == "cpu":
        return fused_bn_act_conv_plain(x, scale, shift, weight, slope=slope)
    tensors = (x, scale, shift, weight)
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise ValueError("fused_conv kernel takes float32 tensors on one card")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_conv kernel takes x in channels_last format")
    if cin % 4 or cout % 4 or scale.shape != (cin,) or shift.shape != (cin,):
        raise ValueError(f"fused_conv kernel needs Cin and Cout multiples of "
                         f"4 and (Cin,) scale/shift; got Cin={cin}, "
                         f"Cout={cout}, {tuple(scale.shape)}/"
                         f"{tuple(shift.shape)}")
    w2 = weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    if any(t.data_ptr() % 16 for t in (x, scale, shift, w2, y)):
        raise ValueError("fused_conv kernel needs 16-byte aligned tensors")
    err = _lib()(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 w2.data_ptr(), y.data_ptr(), b, h, w, cin, cout, slope,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed: CUDA error {err}")
    fused_bn_act_conv.launches += 1
    return y


def _conv_grads(g, act, weight):
    """The library's dgrad and wgrad of the 3x3 SAME conv of ``act``:
    (d act, d weight)."""
    dact, dw, _ = torch.ops.aten.convolution_backward(
        g.contiguous(memory_format=torch.channels_last), act, weight, None,
        (1, 1), (1, 1), (1, 1), False, (0, 0), 1, (True, True, False))
    return dact, dw


class _FusedBnActConv(torch.autograd.Function):
    """The eval-mode site; backward as ``_fused_bwd`` (fused_conv.py:215)."""

    @staticmethod
    def forward(ctx, x, scale, shift, weight, slope):
        ctx.save_for_backward(x, scale, shift, weight)
        ctx.slope = slope
        return _fused_conv_forward(x, scale, shift, weight, slope)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, weight = ctx.saved_tensors
        pre = x * scale[:, None, None] + shift[:, None, None]
        positive = pre > 0
        act = torch.where(positive, pre, ctx.slope * pre)
        dact, dw = _conv_grads(g, act, weight)
        gp = dact * torch.where(positive, 1.0, ctx.slope)
        return (gp * scale[:, None, None], (gp * x).sum((0, 2, 3)),
                gp.sum((0, 2, 3)), dw, None)


def fused_bn_act_conv(x, scale, shift, weight, *, slope: float = LEAKY_SLOPE):
    """``conv3x3_SAME(leaky(x * scale + shift), weight)``, stride 1.

    x: (B, Cin, H, W), channels_last on the card; scale/shift: (Cin,) f32;
    weight: (Cout, Cin, 3, 3). Returns (B, Cout, H, W) in channels_last.
    Differentiable in all four, with the JAX VJP.
    """
    return _FusedBnActConv.apply(x, scale, shift, weight, slope)


fused_bn_act_conv.launches = 0


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
    the biased batch statistics of x (B, Cin, H, W) that feed the
    running-stat update. Differentiable in x, gamma, beta and weight."""
    return _FusedBnActConvTrain.apply(x, gamma, beta, weight, eps, slope)


def fused_bn_act_conv_train_plain(x, gamma, beta, weight, *,
                                  eps: float = 1e-5,
                                  slope: float = LEAKY_SLOPE):
    """The train-mode site as plain differentiable torch ops, for comparing
    values and gradients with the kernels."""
    x32 = x.to(torch.float32)
    mean = x32.mean((0, 2, 3))
    var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
    xhat = (x32 - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    pre = xhat * gamma[:, None, None] + beta[:, None, None]
    act = torch.where(pre >= 0, pre, slope * pre)
    return F.conv2d(act, weight, padding=1), mean, var
