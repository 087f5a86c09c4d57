"""Host milliseconds in the port's ``chunk.seed`` spans (seeding each
step's device generators from its host generators, its mixup weights and
its rate) per ``chunk.run``, over the traced window."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "chunk.seed", "chunk.run")
