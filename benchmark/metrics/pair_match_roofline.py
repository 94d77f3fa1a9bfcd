"""Kernel 1's share of its roofline in the traced pass, in percent."""

from benchmark.roofline import pair_match


def read(t):
    return t.roofline(pair_match, "pair_match")
