"""Native (C++) host-side point reading (`bdm_tpu/native/`, copied).

`pointio.cpp`: threaded .npy/.ply point-cloud reading + subsampling that
releases the GIL, built with `g++` at first use into
`bdm_tpu_torch/_build/`. A host file reader, not a device kernel: without
a compiler it falls back to NumPy, the reference's behaviour.
"""

from bdm_tpu_torch.native.pointio import (
    native_available,
    read_many_npy,
    read_points,
)

__all__ = ["native_available", "read_points", "read_many_npy"]
