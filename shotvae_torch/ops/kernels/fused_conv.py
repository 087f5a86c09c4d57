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
per call into the (9*Cin, Cout) matrix the kernel reads. The backward comes
with the training slice.

On the CPU the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from shotvae_torch.ops.kernels import _build

LEAKY_SLOPE = 0.01


def bn_affine_from_stats(mean, var, gamma, beta, eps: float = 1e-5):
    """Fold BatchNorm statistics and the learned affine into f32
    (scale, shift) (fused_conv.py:244-248)."""
    scale = (gamma * torch.rsqrt(var + eps)).to(torch.float32)
    return scale, (beta - mean * scale).to(torch.float32)


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


def fused_bn_act_conv(x, scale, shift, weight, *, slope: float = LEAKY_SLOPE):
    """``conv3x3_SAME(leaky(x * scale + shift), weight)``, stride 1.

    x: (B, Cin, H, W), channels_last on the card; scale/shift: (Cin,) f32;
    weight: (Cout, Cin, 3, 3). Returns (B, Cout, H, W) in channels_last.
    """
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


fused_bn_act_conv.launches = 0
