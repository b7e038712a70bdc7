"""The least time the port's own kernels of a step need
(`counting.kernel_launches`) over the device time they took in the
traced stretch, in %; nothing when none of them ran."""


def read(o):
    if o.trace is None or o.trace.own_s <= 0:
        return None
    return 100.0 * o.bound_s_per_step * o.trace.steps / o.trace.own_s
