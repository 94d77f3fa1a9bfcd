"""Kernel 4's share of its roofline in the traced pass, in percent."""

from benchmark.roofline import plane_cost


def read(t):
    return t.roofline(plane_cost, "plane_cost")
