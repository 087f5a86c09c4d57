"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
launch counter per data type (``<wrapper>.launches`` for float32,
``<wrapper>.launches_bf16`` for bfloat16)."""

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


def init_counts(*wrappers) -> None:
    for wrapper in wrappers:
        wrapper.launches = wrapper.launches_bf16 = 0


def refuse_grad(name: str, training_path: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad: the kernel
    has no gradient (as in the JAX package), and its output would silently
    cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient, as in the JAX package; run it under "
            f"torch.no_grad() or torch.inference_mode(), and train through "
            f"{training_path}")
