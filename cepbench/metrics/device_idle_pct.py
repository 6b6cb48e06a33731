"""Share of the traced stretch in which no activity ran on the device:
100 * (1 - union of the device-busy intervals / the stretch)."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
