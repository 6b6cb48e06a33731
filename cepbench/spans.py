"""The program's own spans over the traced stretch, for the per-layer
readers of ``metrics/``.

``repro_torch.core.spans`` records spans at the serving path's layer
boundaries on ``time.time_ns()``, the clock ``torch.profiler`` stamps its
events on; nothing of it shows in the profile, so the device trace's
readings are the same with the recorder on or off.

A reader takes ``install`` from here.  The first ``install(run)`` of a
stretch turns the recorder on and notes the profile's own
``trace_start_ns`` when the profiler stops; each reader's ``undo`` counts
down, and the last turns the recorder off and leaves in
``run.hooks[KEY]`` the drained spans, the spans dropped past the
recorder's cap and ``trace_start_ns`` (None where the profile gave
none).  A program without
the recorder records nothing, and its readers return None.
"""

from __future__ import annotations

from cepbench.trace import _merge

KEY = "cep.spans"


def _trace_start_ns(prof):
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    return None if res is None else int(res.trace_start_ns())


def install(run):
    try:
        from repro_torch.core import spans as recorder
    except ImportError:  # a program without its own spans
        return None
    st = run.hooks.get(KEY)
    if st is None:
        from torch.profiler import profile

        st = run.hooks[KEY] = {"users": 0, "spans": [], "dropped": 0,
                               "trace_start_ns": None}
        inner = profile.__exit__

        def exit_(self, *exc):
            out = inner(self, *exc)
            st["trace_start_ns"] = _trace_start_ns(self)
            return out

        profile.__exit__ = exit_
        st["restore"] = lambda: setattr(profile, "__exit__", inner)
        recorder.drain()
        recorder.enable()
    st["users"] += 1

    def undo():
        st["users"] -= 1
        if st["users"] == 0:
            recorder.disable()
            st["spans"], st["dropped"] = recorder.drain()
            st.pop("restore")()
    return undo


def recorded(run):
    """The stretch's spans and profile start, or None where the program
    recorded no span."""
    st = run.hooks.get(KEY)
    return st if st and st["spans"] else None


def named(spans, name: str):
    return [s for s in spans if s.name == name]


def total_ms(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in named(spans, name)) / 1e6


def self_ms(spans, name: str) -> float:
    """The ``name`` spans' time less the part of it their child spans
    cover (the choosing-metrics guide's self time)."""
    kids = {}
    for s in spans:
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = 0
    for i, s in enumerate(spans):
        if s.name != name:
            continue
        covered = sum(min(e, s.end_ns) - max(b, s.start_ns) for b, e in
                      _merge(kids.get(i, [])) if e > s.start_ns
                      and b < s.end_ns)
        out += s.end_ns - s.start_ns - covered
    return out / 1e6


def per_chunk_ms(run, name: str):
    """Milliseconds per chunk of the stretch in ``name`` spans; None where
    the program recorded none."""
    st = recorded(run)
    if st is None or run.chunks == 0 or not named(st["spans"], name):
        return None
    return total_ms(st["spans"], name) / run.chunks


def on_trace_us(run, name: str):
    """The ``name`` spans as intervals of the profile's microseconds
    (the times ``torch.profiler`` gives its events), merged; None where
    the program recorded none or the profile's start is unknown."""
    st = recorded(run)
    if st is None or st["trace_start_ns"] is None:
        return None
    t0 = st["trace_start_ns"]
    return _merge([((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3)
                   for s in named(st["spans"], name)])


def overlap_us(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_us(intervals, busy, start_us: float, end_us: float) -> float:
    """The part of ``intervals`` inside ``[start_us, end_us]`` in which the
    device was idle: covered by no interval of ``busy`` (merged)."""
    inside = _merge([(max(s, start_us), min(e, end_us))
                     for s, e in intervals if e > start_us and s < end_us])
    return sum(e - s for s, e in inside) - overlap_us(inside, busy)
