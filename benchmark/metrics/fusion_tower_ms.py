"""Device ms of the kernels and copies launched inside the program's
`fusion.pvd_tower` span (inclusive: the PVD encoder tower of the fusion
network), over one eager fusion step in the spans stretch; nothing for a
program without that span."""


def read(o):
    t = o.notes.get("spans")
    r = t and t["rows"].get("fusion.pvd_tower")
    if not r:
        return None
    return r["device_us"] * 1e-3 / t["steps"]
