"""The host's kernel and graph launch calls of one fusion step as the
window runs it (the CUDA runtime's records in its traced stretch): some
2,000 where the fusion network runs eagerly, the projection's and the
update's and one graph launch where it is replayed."""


def read(o):
    s = o.notes.get("fusion")
    if s is None:
        return None
    return s.launches / s.steps
