"""Host milliseconds from the call to ``classify`` to its return, before
the readback (the host's enqueue of the call), the mean over the traced
calls."""


def read(run):
    spans = run.trace.span_s("classify")
    return 1e3 * sum(spans) / len(spans) if spans else None
