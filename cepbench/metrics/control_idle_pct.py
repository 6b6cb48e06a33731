"""Share of the traced stretch in which the device sat idle while the
host ran the program's ``cep.control`` spans: 100 * (the device's idle
time inside those spans) / the stretch.  The spans go onto the profile's
clock through the profile's own ``trace_start_ns``; the idle time is the
complement of the trace's busy intervals, so the share never exceeds
``device_idle_pct``."""

from cepbench.spans import idle_us, install, on_trace_us  # noqa: F401


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    control = on_trace_us(run, "cep.control")
    if not control:
        return None
    t = run.trace
    idle = idle_us(control, t.busy_intervals(), t.start_us, t.end_us)
    return 100.0 * idle / (t.end_us - t.start_us)
