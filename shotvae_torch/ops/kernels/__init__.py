"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
launch counter (``<wrapper>.launches``)."""
