"""Device resolution and float32 precision for the port's entry points.

The port runs on the card. The CPU is taken only when the caller names it
(``device="cpu"``, as the tests do); a missing card is an error, never a
quiet fall-through to the plain PyTorch path. Its entry points compute
float32 in full float32 (``exact_f32``), as the JAX package and every
check of the port do, whatever PyTorch's TF32 default.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    this process sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shotvae_torch runs on a CUDA card and torch sees none; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev



def _precision_knobs():
    """The TF32 switches of cuDNN's convolutions and cuBLAS's matmuls, as
    (object, attribute, value with TF32 off) triples. These are the
    ``allow_tf32`` flags, which every torch reads, unless the caller set
    the per-operator precisions of torch 2.9 and later (``fp32_precision``:
    "ieee", "tf32" or "none", which inherits) in a way the flags cannot
    read back; then those."""
    b = torch.backends
    try:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
        return [(b.cudnn, "allow_tf32", False),
                (b.cuda.matmul, "allow_tf32", False)]
    except RuntimeError:
        return [(b.cudnn.conv, "fp32_precision", "ieee"),
                (b.cudnn.rnn, "fp32_precision", "ieee"),
                (b.cuda.matmul, "fp32_precision", "ieee")]


@contextlib.contextmanager
def exact_f32():
    """Inside, cuDNN convolutions and cuBLAS matmuls take float32 inputs in
    full float32 (no TF32), the arithmetic every check of the port holds;
    on exit the caller's settings come back as they were, through the
    switches they were read from. PyTorch's default lets cuDNN convolve
    float32 in TF32 (10-bit mantissas). The port's entry points (the CLIs,
    ``run_*`` and ``ShotVaeInference``) run inside it; bfloat16 data is not
    affected."""
    knobs = _precision_knobs()
    saved = [getattr(obj, name) for obj, name, _ in knobs]
    try:
        for obj, name, off in knobs:
            setattr(obj, name, off)
        yield
    finally:
        for (obj, name, _), value in zip(knobs, saved):
            setattr(obj, name, value)
