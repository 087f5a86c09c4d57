"""1 - (the union of the device's busy intervals / the traced window), in
%, over the traced block of calls."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
