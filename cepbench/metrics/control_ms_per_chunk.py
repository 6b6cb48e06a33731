"""Host milliseconds per chunk in the program's ``cep.control`` spans
(``serving/engine.py::_apply_flags``, once a readback: per flagged
partition its statistic reads, the planner, the policy's lowering and the
plan-row deploy), over the traced stretch."""

from cepbench.spans import install, per_chunk_ms  # noqa: F401


def read(run):
    return per_chunk_ms(run, "cep.control")
