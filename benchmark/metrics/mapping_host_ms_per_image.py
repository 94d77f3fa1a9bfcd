"""The device mapper's host-only work: the program's ``mapping.prepare``
(track building and the registration order) and ``mapping.unpack``
(the result into a model) spans in the traced pass's mapping stage, ms
per offered image. None where the program records neither."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds("mapping", "mapping.prepare", "mapping.unpack")
    return None if s is None else 1e3 * s / t.images
