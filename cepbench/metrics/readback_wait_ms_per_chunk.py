"""Host milliseconds per chunk in the program's ``cep.readback`` spans,
where the host waits for the device and reads back the counters, flags
and drift (a chunk's ``_accumulate`` and flag transfer; a window's
``ys.host``), over the traced stretch."""

from cepbench.spans import install, per_chunk_ms  # noqa: F401


def read(run):
    return per_chunk_ms(run, "cep.readback")
