"""Tracks the device mapper dropped past its track capacity (the program's
``mapping.tracks_dropped`` counter, 0 for a cluster that kept them all) in
the traced pass's mapping stage, per offered image. None where the
program does not count them."""

from benchmark.harness import program


def read(t):
    n = program.counter("mapping", "mapping.tracks_dropped")
    return None if n is None else n / t.images
