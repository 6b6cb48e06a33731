"""Device milliseconds per chunk of the hand-written kernels of
``csrc/window_join.cu`` (the packed and unpacked joins, the row and pair
counts, the survivor selection), from the profile."""

from cepbench.trace import KERNELS


def read(run):
    if run.trace is None or run.chunks == 0:
        return None
    s = run.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    return s * 1e3 / run.chunks if s > 0 else None
