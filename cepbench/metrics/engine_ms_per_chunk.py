"""Device milliseconds per chunk of every activity not built from
``csrc/window_join.cu``: the engine's torch operations (ingest, gathers,
compaction, statistics, invariants), copies and sets, from the profile."""

from cepbench.trace import KERNELS


def read(run):
    if run.trace is None or not run.trace.device_ops or run.chunks == 0:
        return None
    s = run.trace.device_seconds(lambda n: not any(k in n for k in KERNELS))
    return s * 1e3 / run.chunks
