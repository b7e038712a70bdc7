"""The share of the traced stretch in which no kernel or copy ran on
the device, in %."""


def read(o):
    if o.trace is None:
        return None
    return 100.0 * (1.0 - o.trace.busy_s / o.trace.wall_s)
