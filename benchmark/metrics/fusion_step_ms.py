"""Device ms of one fusion step (`nstep_fuse`: the re-centring, the
projection, the fusion network's forward and the DDPM update) as the
window runs it, in its traced stretch: the union of the device's kernel
and copy intervals. Nothing for a driver that takes no such stretch."""


def read(o):
    s = o.notes.get("fusion")
    if s is None:
        return None
    return s.busy_s * 1e3 / s.steps
