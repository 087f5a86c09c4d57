"""Host milliseconds per ``ChunkRunner.run`` call (writing a chunk's
static inputs and launching its replay, no synchronise), the mean over
the traced window's chunks."""


def read(run):
    spans = run.trace.span_s("runner.run")
    return 1e3 * sum(spans) / len(spans) if spans else None
