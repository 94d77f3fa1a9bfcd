"""The share of the traced pass's bundle adjustment inside the device
mapper (the union of the program's ``mapping.ba`` spans) in which the
device ran nothing, in percent: how far the LM loop's host side holds
the device back. None where the trace or the program has nothing."""

from benchmark.harness import program


def read(t):
    return program.idle_share_in(t, "run_mapping", "mapping", "mapping.ba")
