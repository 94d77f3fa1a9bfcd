"""Kernel 2's share of its roofline in the traced pass, in percent."""

from benchmark.roofline import schur


def read(t):
    return t.roofline(schur, "schur")
