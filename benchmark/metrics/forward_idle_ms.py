"""Device idle ms a step in the spans stretch whose gap ends at a kernel
or copy launched inside a `network` span of the program: the part of the
device's idle time that the network's own launch rate leaves. Nothing
for a program without that span."""


def read(o):
    t = o.notes.get("spans")
    r = t and t["rows"].get("network")
    if not r:
        return None
    return r["idle_us"] * 1e-3 / t["steps"]
