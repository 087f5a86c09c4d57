"""Device idle milliseconds while the host was inside the port's
``serve.classify`` spans, per call, over the traced calls."""

from portbench.lib import program


def read(run):
    return program.idle_ms_per(
        run, program.intervals(run, ["serve.classify"]), "serve.classify")
