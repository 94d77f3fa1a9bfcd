"""The merge's batched multi-view triangulation on the device (the
program's ``triangulate.dlt`` spans: each ``_triangulate_tracks`` call of
the host engine, the refinement's retriangulation of every new track
first among them) in every stage of the traced pass, ms per offered
image. None where the program records no such span."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds(None, "triangulate.dlt")
    return None if s is None else 1e3 * s / t.images
