"""Host milliseconds in the port's ``eval.step`` spans (one eval forward's
enqueue, from its batch on the device) per eval forward, over the traced
window."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "eval.step", "eval.step")
