"""Host milliseconds in the port's ``chunk.copy_in`` spans (the copies of a
chunk's index rows and of its scalars from the host) per ``chunk.run``
(one ``ChunkRunner.run`` call), over the traced window."""

from portbench.lib import program


def read(run):
    return program.host_ms_per(run, "chunk.copy_in", "chunk.run")
