"""Host milliseconds per chunk in the program's ``cep.upload`` spans: the
step's inputs put on the device (``core/fleet.py::FleetEngine._inputs``:
the chunk, the plan operands, the clock; in a window, ``stack_window``
and the window's staging), over the traced stretch."""

from cepbench.spans import install, per_chunk_ms  # noqa: F401


def read(run):
    return per_chunk_ms(run, "cep.upload")
