"""Host milliseconds in the port's ``serve.copy_in`` spans (a call's uint8
batch copied from the host to the card) per ``serve.classify`` call, over
the traced calls."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "serve.copy_in", "serve.classify")
