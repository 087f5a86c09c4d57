"""Host milliseconds in the port's ``serve.forward`` spans (the encoder's
and the probabilities' enqueue) per ``serve.classify`` call, over the
traced calls."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "serve.forward", "serve.classify")
