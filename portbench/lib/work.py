"""The yardstick's own counts: the H100's peaks, the FLOPs of a step and of
a forward from the configuration's widths, and each hand kernel's launches
and least time at the shapes the configuration gives it.

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory bandwidth, each input read once and each
output written once (the arithmetic of chip_smoke.py's bound columns,
copied here). The sites: in the trunk every BatchNorm whose activation
feeds a stride-1 3x3 conv is one fused conv launch behind a statistics
launch; every other BatchNorm (before a stride-2 or 1x1 conv, the
transition, the decoder's) is a standalone site.
"""

from __future__ import annotations

from portbench.reference.model import (decoder_widths, encoder_units,
                                       forward_flops)

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 outside the tensor cores


def sites(model: dict, batch: int) -> dict:
    """The hand kernels' sites of one forward at ``batch``: ``fused``
    (B, Cin, H, W, Cout) convs, ``encoder_bn`` and ``decoder_bn`` (M, C)
    standalone BatchNorms."""
    units, _, feat = encoder_units(model["net_name"])
    hw = model["image_size"]
    fused, enc = [], []
    for _, cin, cout, stride in units:
        out_hw = hw // stride
        if stride == 1:
            fused.append((batch, cin, hw, hw, cout))
        else:
            enc.append((batch * hw * hw, cin))
        fused.append((batch, cout, out_hw, out_hw, cout))
        if cin != cout or stride != 1:
            enc.append((batch * hw * hw, cin))
        hw = out_hw
    enc.append((batch * hw * hw, feat))
    dec, side = [], 1
    for i, c in enumerate(decoder_widths(model)):
        side = 1 if i == 0 else side * 2
        dec.append((batch * side * side, c))
    return {"fused": fused, "encoder_bn": enc, "decoder_bn": dec}


def conv_bound_s(shape, elem_bytes: int, peak_flops: float) -> float:
    b, cin, h, w, cout = shape
    flops = 2 * b * h * w * 9 * cin * cout
    nbytes = elem_bytes * (b * h * w * (cin + cout) + 9 * cin * cout) \
        + 8 * cin
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def bn_bytes(kernel: str, m: int, c: int, e: int) -> int:
    """Bytes of one launch of a bn_leaky kernel on (M, C) rows whose x, y,
    g and dx are ``e``-byte elements (xhat, statistics and sums float32)."""
    return {"stats": e * m * c + 12 * c,
            "apply": (2 * e + 4) * m * c + 20 * c,
            "bwd_reduce": (e + 4) * m * c + 16 * c,
            "bwd_apply": (2 * e + 4) * m * c + 28 * c}[kernel]


def shot_step_launches(model: dict, batch: int) -> dict:
    """{kernel: [(shape, launches)]} of one SHOT-VAE train step at batch
    + batch (four forwards; the decoders of the two interpolation
    forwards take no gradient)."""
    s = sites(model, batch)
    fused_in = [(b * h * w, cin) for b, cin, h, w, _ in s["fused"]]
    enc = s["encoder_bn"] + fused_in
    return {"stats": [(x, 4) for x in enc + s["decoder_bn"]],
            "apply": [(x, 4) for x in s["encoder_bn"] + s["decoder_bn"]
                      + fused_in],
            "bwd_reduce": [(x, 4) for x in enc]
            + [(x, 2) for x in s["decoder_bn"]],
            "bwd_apply": [(x, 4) for x in enc]
            + [(x, 2) for x in s["decoder_bn"]],
            "conv": [(x, 4) for x in s["fused"]]}


def eval_forward_launches(model: dict, batch: int) -> dict:
    """{kernel: [(shape, launches)]} of one eval-mode forward."""
    s = sites(model, batch)
    return {"conv": [(x, 1) for x in s["fused"]],
            "bn_act": [(x, 1) for x in s["encoder_bn"] + s["decoder_bn"]]}


def step_flops(model: dict, batch: int) -> float:
    """Model FLOPs of one SHOT-VAE train step at batch + batch: the four
    forwards, and twice each forward's layers for the backward where the
    loss's gradient passes (no gradient of the images; the interpolation
    forwards' decoders take none). Recomputation is not counted."""
    f = forward_flops(model, batch)
    forward = f["encoder"] + f["heads"] + f["decoder"]
    backward = (4 * (2 * f["encoder"] - f["stem"]) + 4 * 2 * f["heads"]
                + 2 * 2 * f["decoder"])
    return 4 * forward + backward


def eval_flops(model: dict, batch: int) -> float:
    """One eval-mode forward (encoder, heads, decoder)."""
    f = forward_flops(model, batch)
    return f["encoder"] + f["heads"] + f["decoder"]


def classify_flops(model: dict, batch: int) -> float:
    """One ``classify`` call: the encoder and the heads."""
    f = forward_flops(model, batch)
    return f["encoder"] + f["heads"]
