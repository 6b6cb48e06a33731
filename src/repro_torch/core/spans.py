"""The port's tracing: spans at the layer boundaries of the CEP serving
path, kept in memory.

    from repro_torch.cep import spans

    spans.enable()
    session.step(chunk, t0, t1)
    spans.disable()
    records, dropped = spans.drain()

A span records its name, its start and end on ``time.time_ns()``, the
index of the span that encloses it (its parent, -1 at the top) and the
id of the call it belongs to: a sequence number given by the outermost
span, shared by every span inside it.  ``time.time_ns()`` is the clock
``torch.profiler`` stamps its events on (Unix-epoch nanoseconds; an
event's time in the profile is its stamp less the profile's
``trace_start_ns``), so spans map onto a device trace.  Nothing here
shows in the profile: a ``record_function`` range around device launches
also appears as a device-side annotation, which a trace reader would
count as busy device time.

Span names (the serving path, ``cep/session.py`` down to ``core/scan.py``):

* ``cep.call``: one ``Session.step`` / ``step_superchunk`` / ``process`` /
  ``run``; it gives the call id.
* ``cep.engine``: the data plane of one chunk or window (or one chunk of
  ``run``), with ``cep.upload`` (host inputs to the device; inside it
  ``cep.plan_operands``, the plan matrix's device operands, stacked on the
  host from each order row's kept strips and uploaded when the matrix is
  not cached) and ``cep.readback`` (the host waits for and reads back
  counters, flags and drift).
* ``cep.control``: the host control after a readback, with per flagged
  partition ``cep.stat_read`` (its statistics to the host), ``cep.plan``
  (the planner), ``cep.lower`` (the policy's invariant set lowered and
  written to its device row) and ``cep.deploy`` (the plan-row write).

The flags handled and the plans changed are counted where they always
were: ``Telemetry.violations`` and ``Telemetry.replans``.

Off (the default) ``span(name)`` returns one shared no-op context
manager: no clock read, no allocation.  On, spans past ``CAP`` are not
kept and are counted as dropped; their ``seconds`` are still measured.
One recorder serves the process and assumes one thread drives the
program.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

__all__ = ["Span", "Recorder", "enable", "disable", "drain", "span", "CAP"]

CAP = 1 << 18  # spans kept between two drains


class Span(NamedTuple):
    """One finished span, as ``drain`` returns it."""

    name: str
    start_ns: int
    end_ns: int
    parent: int   # index of the enclosing span in the drained list, or -1
    call: int     # id of the outermost span's call


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded; ``seconds`` is its length once it ends."""

    __slots__ = ("rec", "name", "index", "parent", "call", "start_ns",
                 "end_ns")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name
        self.end_ns = 0

    def __enter__(self):
        rec = self.rec
        if rec.stack:
            top = rec.stack[-1]
            self.parent, self.call = top.index, top.call
        else:
            self.parent, self.call = -1, rec.calls
            rec.calls += 1
        self.index = rec.opened
        rec.opened += 1
        if self.index < rec.cap:
            rec.kept.append(self)
        else:
            rec.dropped += 1
        rec.stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.rec.stack.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Recorder:
    """Spans in memory, at most ``cap`` between two drains."""

    def __init__(self, cap: int = CAP):
        self.cap = int(cap)
        self.on = False
        self.stack: List[_Open] = []
        self.calls = 0
        self._reset()

    def _reset(self) -> None:
        self.kept: List[_Open] = []
        self.opened = 0
        self.dropped = 0
        for s in self.stack:  # open across a drain: no index any more
            s.index = -1

    def span(self, name: str):
        """A context manager recording span ``name`` while tracing is on;
        ``seconds`` on it is the span's length (0.0 while off)."""
        if not self.on:
            return _OFF
        return _Open(self, name)

    def enable(self) -> None:
        """Turn tracing on."""
        self.on = True

    def disable(self) -> None:
        """Turn tracing off; what was recorded stays until ``drain``."""
        self.on = False

    def drain(self) -> Tuple[List[Span], int]:
        """The finished spans in the order they started and the number of
        spans dropped past the cap; both start again from empty.  Spans
        still open are left out, and their children get parent -1."""
        done = [s for s in self.kept if s.end_ns]
        new = {s.index: i for i, s in enumerate(done)}
        out = [Span(s.name, s.start_ns, s.end_ns, new.get(s.parent, -1),
                    s.call) for s in done]
        dropped = self.dropped
        self._reset()
        return out, dropped


# The process's recorder: the program's spans go here.
_REC = Recorder()
span = _REC.span
enable = _REC.enable
disable = _REC.disable
drain = _REC.drain
