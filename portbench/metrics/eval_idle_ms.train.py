"""Device idle milliseconds while the host was inside the port's
``eval.step`` or ``data.gather`` spans (the eval batches' gathers; not the
train steps'), per ``eval.step``, over the traced window."""

from portbench.lib import program


def read(run):
    spans = program.intervals(run, ["eval.step", "data.gather"],
                              outside_chunks=True)
    return program.idle_ms_per(run, spans, "eval.step")
