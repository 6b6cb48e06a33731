"""A window of ``superchunk`` chunks a call:
``Session.step_superchunk(chunks, edges)`` of a ``repro_torch.cep``
session opened with that window length."""

from cepbench.harness import open_cep_session


def chunks_per_call(traffic: dict) -> int:
    return int(traffic["superchunk"])


def open_session(cell, pattern, device: str):
    return open_cep_session(cell, pattern, device)


def prepare(batch):
    """The call's arguments, built before the clock starts."""
    from repro_torch.core.engine import Chunk

    return [Chunk(*a) for a, _ in batch], [e for _, e in batch]


def call(session, args):
    """``(S, K)`` match counts on the host."""
    return session.step_superchunk(*args)
