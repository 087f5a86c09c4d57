"""Share of the traced window the host spent in the epochs' eval passes
(each span ended by the read of a split's sums, which waits for the
card), in %."""


def read(run):
    spent = sum(run.trace.span_s("eval"))
    return 100.0 * spent / run.trace.window_s if spent else None
