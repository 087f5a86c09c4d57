"""Device idle milliseconds while the host was inside the port's
``chunk.run`` spans, per ``chunk.run``, over the traced window."""

from portbench.lib import program


def read(run):
    return program.idle_ms_per(run, program.intervals(run, ["chunk.run"]),
                               "chunk.run")
