"""Device-to-host reads of the traced pass's mapping stage (the program's
``host_reads`` counter at each read on the device mapper's path), per
offered image: each drains the queue of launches. None where the program
does not count them."""

from benchmark.harness import program


def read(t):
    n = program.counter("mapping", "host_reads")
    return None if n is None else n / t.images
