"""The share of the traced pass's wall time in which the device ran
nothing, in percent: one minus the union of its activity intervals over
the pass. None where the trace holds no device activity."""


def read(t):
    busy = t.busy_s()
    return 100.0 * (1.0 - busy / t.window_s()) if busy > 0 else None
