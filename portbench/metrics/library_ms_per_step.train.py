"""Device milliseconds of every kernel that is not the port's own (cuDNN,
cuBLAS, ATen) in the traced window, per train step."""


def read(run):
    steps = run.counts["steps"]
    spent = sum(e - s for n, s, e in run.trace.kernels if run.own(n) is None)
    return spent / 1e6 / steps if steps and spent else None
