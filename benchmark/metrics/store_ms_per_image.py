"""Artifact store reads and writes (the program's ``store.read`` and
``store.write`` spans; a write fsyncs every file) in every stage of the
traced pass, ms per offered image. None where the program records
neither."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds(None, "store.read", "store.write")
    return None if s is None else 1e3 * s / t.images
