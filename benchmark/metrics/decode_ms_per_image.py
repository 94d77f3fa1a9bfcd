"""JPEG decode, gray and resize (the program's ``image.decode`` spans) in
every stage of the traced pass, extraction's decode thread included, ms
(thread seconds) per offered image. None where the program records no
such span."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds(None, "image.decode")
    return None if s is None else 1e3 * s / t.images
