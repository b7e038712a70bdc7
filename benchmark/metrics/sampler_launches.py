"""The host's launches a step outside every `network` span of the
program (the projection, the scheduler's update, its noise and the
timestep tensor), in the spans stretch: what a capture of the denoiser
alone would leave to the host. Nothing for a program without that
span."""


def read(o):
    t = o.notes.get("spans")
    r = t and t["rows"].get("network")
    if not r:
        return None
    return (t["launches"] - r["launches"]) / t["steps"]
