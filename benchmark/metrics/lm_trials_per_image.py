"""LM trials of the traced pass's mapping stage (the program's
``ba.lm_trials`` counter: one a pass of an LM loop, a batched trial once,
whatever its lanes), per offered image. None where the program does not
count them."""

from benchmark.harness import program


def read(t):
    n = program.counter("mapping", "ba.lm_trials")
    return None if n is None else n / t.images
