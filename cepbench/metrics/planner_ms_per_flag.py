"""Host milliseconds of planner per flagged partition: the self time of
the program's ``cep.plan`` spans (the planner re-run on a flagged
partition's statistics, ``core/fleet.py::replan_flagged_partition``) over
the flags handled, the session's ``telemetry().violations`` over the
traced stretch.  Nothing to read where no flag fired."""

from cepbench.spans import install, recorded, self_ms  # noqa: F401


def read(run):
    st = recorded(run)
    flags = run.counters.get("telemetry.violations", 0)
    if st is None or flags == 0:
        return None
    return self_ms(st["spans"], "cep.plan") / flags
