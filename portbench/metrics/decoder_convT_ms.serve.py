"""Device milliseconds a traced call in the decoder's ConvTranspose
kernels: cuDNN runs a transposed conv as the data gradient of a conv, so
its kernels carry ``dgrad`` in their names, and a serving call takes no
gradient anywhere else. None where the trace holds no such kernel."""

import re

DGRAD = re.compile(r"dgrad")


def read(run):
    calls = run.counts["calls"]
    spent = sum(e - s for n, s, e in run.trace.kernels if DGRAD.search(n))
    return spent / 1e6 / calls if calls and spent else None
