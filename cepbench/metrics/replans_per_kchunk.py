"""Replans per thousand chunks over the traced stretch: the session's
``telemetry().replans`` (partitions whose invariant flag fired and whose
planner then chose another plan), counted by the program."""


def read(run):
    if run.chunks == 0:
        return None
    return run.counters["telemetry.replans"] * 1000.0 / run.chunks
