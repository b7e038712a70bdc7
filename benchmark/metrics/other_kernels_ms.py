"""Device ms a step of the kernels not built from the port's own
sources (PyTorch's, cuBLAS's, cuDNN's), in the traced stretch."""


def read(o):
    if o.trace is None:
        return None
    return o.trace.other_s * 1e3 / o.trace.steps
