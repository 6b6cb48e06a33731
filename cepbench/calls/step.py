"""One chunk a call: ``Session.step(chunk, t0, t1)`` of a
``repro_torch.cep`` session."""

from cepbench.harness import open_cep_session


def chunks_per_call(traffic: dict) -> int:
    return 1


def open_session(cell, pattern, device: str):
    return open_cep_session(cell, pattern, device)


def prepare(batch):
    """The call's arguments, built before the clock starts."""
    from repro_torch.core.engine import Chunk

    (arrays, (t0, t1)), = batch
    return Chunk(*arrays), t0, t1


def call(session, args):
    """``(1, K)`` match counts on the host."""
    return session.step(*args)[None]
