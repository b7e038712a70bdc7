"""The host's kernel and graph launch calls a step in the traced
stretch (the CUDA runtime's records in the device trace)."""


def read(o):
    if o.trace is None:
        return None
    return o.trace.launches / o.trace.steps
