"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
launch counter per data type (``<wrapper>.launches`` for float32,
``<wrapper>.launches_bf16`` for bfloat16).

A wrapper counts in Python as it launches, so a CUDA graph's replay moves
no counter by itself: ``held_counts`` takes a capture's counts back out
and gives them as the graph's launches, which ``add_counts`` adds at each
replay."""

import contextlib
import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """The number of SMs of CUDA card ``index``, which sizes persistent
    grids."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """Count one launch of ``wrapper``'s kernel for ``dtype`` data."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


_COUNTED: list = []  # every wrapper with launch counters


def init_counts(*wrappers) -> None:
    for wrapper in wrappers:
        wrapper.launches = wrapper.launches_bf16 = 0
        if not any(w is wrapper for w in _COUNTED):
            _COUNTED.append(wrapper)


@contextlib.contextmanager
def held_counts():
    """Counts made inside are taken back out on leaving, and the yielded
    dict then holds them: {wrapper: (float32, bfloat16) launches}."""
    before = [(w, w.launches, w.launches_bf16) for w in _COUNTED]
    made: dict = {}
    try:
        yield made
    finally:
        for w, f32, bf16 in before:
            made[w] = (w.launches - f32, w.launches_bf16 - bf16)
            w.launches, w.launches_bf16 = f32, bf16


def add_counts(made: dict) -> None:
    """Add ``held_counts``' launches to the counters."""
    for w, (f32, bf16) in made.items():
        w.launches += f32
        w.launches_bf16 += bf16


def refuse_grad(name: str, training_path: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad: the kernel
    has no gradient (as in the JAX package), and its output would silently
    cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient, as in the JAX package; run it under "
            f"torch.no_grad() or torch.inference_mode(), and train through "
            f"{training_path}")
