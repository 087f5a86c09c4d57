"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
launch counter per data type (``<wrapper>.launches`` for float32,
``<wrapper>.launches_bf16`` for bfloat16), and, where a kernel has more
than one work item, a counter of the launches that took one of them (its
``extra`` counters, e.g. ``fused_bn_act_conv.launches_bf16_packed`` and,
of those, ``fused_bn_act_conv.launches_bf16_banded``).

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


def count_launch(wrapper, dtype: torch.dtype, *extra: str) -> None:
    """Count one launch of ``wrapper``'s kernel for ``dtype`` data, and on
    each of its ``extra`` counters given."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
    for name in extra:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


_COUNTED: list = []  # every wrapper with launch counters
_EXTRA: list = []    # (wrapper, counter) of every extra counter


def init_counts(*wrappers, extra: tuple = ()) -> None:
    for wrapper in wrappers:
        wrapper.launches = wrapper.launches_bf16 = 0
        if not any(w is wrapper for w in _COUNTED):
            _COUNTED.append(wrapper)
        for name in extra:
            setattr(wrapper, name, 0)
            if not any(w is wrapper and n == name for w, n in _EXTRA):
                _EXTRA.append((wrapper, name))


@contextlib.contextmanager
def held_counts():
    """Counts made inside are taken back out on leaving, and the yielded
    dict then holds them: {wrapper: (float32, bfloat16) launches} and
    {(wrapper, extra counter): launches}."""
    before = [(w, w.launches, w.launches_bf16) for w in _COUNTED]
    extras = [(w, name, getattr(w, name)) for w, name in _EXTRA]
    made: dict = {}
    try:
        yield made
    finally:
        for w, f32, bf16 in before:
            made[w] = (w.launches - f32, w.launches_bf16 - bf16)
            w.launches, w.launches_bf16 = f32, bf16
        for w, name, n in extras:
            made[(w, name)] = getattr(w, name) - n
            setattr(w, name, n)


def add_counts(made: dict) -> None:
    """Add ``held_counts``' launches to the counters."""
    for key, counts in made.items():
        if isinstance(key, tuple):
            w, name = key
            setattr(w, name, getattr(w, name) + counts)
        else:
            f32, bf16 = counts
            key.launches += f32
            key.launches_bf16 += bf16


def refuse_grad(name: str, training_path: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad: the kernel
    has no gradient (as in the JAX package), and its output would silently
    cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient, as in the JAX package; run it under "
            f"torch.no_grad() or torch.inference_mode(), and train through "
            f"{training_path}")
