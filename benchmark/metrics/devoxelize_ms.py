"""Device ms a step of the kernels and copies launched inside the
program's `pvconv.devoxelize` spans (inclusive), in the spans stretch;
nothing for a program without that span."""


def read(o):
    t = o.notes.get("spans")
    r = t and t["rows"].get("pvconv.devoxelize")
    if not r:
        return None
    return r["device_us"] * 1e-3 / t["steps"]
