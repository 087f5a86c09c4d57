"""1 - (the union of the device's busy intervals / the traced window), in
%, over whole traced epochs."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
