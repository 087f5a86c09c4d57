"""Host milliseconds in the port's ``chunk.replay`` spans (the launch of a
chunk's CUDA graph replay) per ``chunk.run``, over the traced window."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "chunk.replay", "chunk.run")
