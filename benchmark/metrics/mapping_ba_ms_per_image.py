"""Bundle adjustment inside the device mapper: the program's ``mapping.ba``
spans (each ``ops/ba.bundle_adjust_lanes`` call, per registration step and
final) in the traced pass's mapping stage, ms per offered image. None where
the program records no such span."""

from benchmark.harness import program


def read(t):
    s = program.span_seconds("mapping", "mapping.ba")
    return None if s is None else 1e3 * s / t.images
