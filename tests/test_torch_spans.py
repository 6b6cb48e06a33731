"""The port's span recorder (``repro_torch.core.spans``) on the serving
path, on the CPU.

Off, a monitored session records nothing and never reads the clock; on,
``step`` and ``step_superchunk`` give the serving path's spans, each
inside its parent and under the call id of its ``cep.call``, with one
``cep.plan`` per violation; ``Telemetry.engine_time_s`` /
``control_time_s`` come from the spans on every front; and a span mapped
onto a ``torch.profiler`` trace through the profile's ``trace_start_ns``
holds the host operation it ran.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig, spans
from repro_torch.core.fleet import FleetEngine, stack_chunks
from repro_torch.data.cep_streams import StreamConfig, make_stream

K = 4
N_CHUNKS = 12
RULE = (P.seq(0, 1, 2)
        .where(P.attr(0) < P.attr(1) - 0.3, P.attr(1) < P.attr(2) - 0.3)
        .within(4.0))
PARENT = {"cep.engine": "cep.call", "cep.control": "cep.call",
          "cep.upload": "cep.engine", "cep.readback": "cep.engine",
          "cep.plan_operands": "cep.upload", "cep.stat_read": "cep.control",
          "cep.plan": "cep.control", "cep.lower": "cep.control",
          "cep.deploy": "cep.control"}


@pytest.fixture(autouse=True)
def _quiet_recorder():
    """Every test starts and ends with tracing off and nothing kept."""
    torch.set_num_threads(1)
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _stream(k=K):
    recs = [list(make_stream("traffic", StreamConfig(
        seed=11 + p, n_types=3, n_chunks=N_CHUNKS, chunk_cap=128,
        base_rate=8.0))) for p in range(k)]
    chunks = [stack_chunks([recs[p][i].chunk for p in range(k)])
              for i in range(N_CHUNKS)]
    edges = [(recs[0][i].t0, recs[0][i].t1) for i in range(N_CHUNKS)]
    return recs, chunks, edges


def _session(superchunk=1, monitor=True):
    return cep.open(RULE, partitions=K, plan="order", monitor=monitor,
                    config=RuntimeConfig(
                        device="cpu", buffer_capacity=64,
                        match_capacity=1024, max_invariants=8, max_terms=16,
                        superchunk=superchunk))


def _drive(session, call, chunks, edges):
    if call == "step":
        return [session.step(c, *e) for c, e in zip(chunks, edges)]
    return [session.step_superchunk(chunks, edges)]


@pytest.mark.parametrize("call", ["step", "step_superchunk"])
def test_off_records_nothing_and_reads_no_clock(monkeypatch, call):
    _, chunks, edges = _stream()
    s = _session(superchunk=4 if call == "step_superchunk" else 1)
    _drive(s, call, chunks[:1], edges[:1])

    def no_clock():
        raise AssertionError("time.time_ns read with tracing off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    _drive(s, call, chunks[1:], edges[1:])
    monkeypatch.undo()
    tel = s.telemetry()
    assert tel.violations > 0
    assert tel.engine_time_s == 0.0 and tel.control_time_s == 0.0
    assert spans.drain() == ([], 0)
    assert spans.span("a") is spans.span("b")


@pytest.mark.parametrize("call", ["step", "step_superchunk"])
def test_on_gives_the_serving_spans_nested_by_call(call):
    _, chunks, edges = _stream()
    s = _session(superchunk=4 if call == "step_superchunk" else 1)
    _drive(s, call, chunks[:1], edges[:1])
    v0, r0 = s.telemetry().violations, s.telemetry().replans
    spans.enable()
    out = _drive(s, call, chunks[1:], edges[1:])
    spans.disable()
    recs, dropped = spans.drain()
    tel = s.telemetry()

    names = {r.name for r in recs}
    assert names == set(PARENT) | {"cep.call"} and dropped == 0
    calls = [r for r in recs if r.name == "cep.call"]
    assert len(calls) == len(out)
    assert len({r.call for r in calls}) == len(calls)
    assert all(r.parent == -1 for r in calls)
    for r in recs:
        if r.name == "cep.call":
            continue
        up = recs[r.parent]
        assert up.name == PARENT[r.name], (r, up)
        assert up.call == r.call
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    # one planner run per violation, one deploy per changed plan
    n_plan = sum(r.name == "cep.plan" for r in recs)
    assert n_plan == tel.violations - v0 > 0
    assert sum(r.name == "cep.deploy" for r in recs) == tel.replans - r0
    assert tel.engine_time_s > 0.0 and tel.control_time_s > 0.0
    engine_s = sum(r.end_ns - r.start_ns for r in recs
                   if r.name == "cep.engine") * 1e-9
    assert tel.engine_time_s == pytest.approx(engine_s)


def test_spans_do_not_change_the_answers():
    _, chunks, edges = _stream()
    s_off, s_on = _session(), _session()
    off = _drive(s_off, "step", chunks, edges)
    spans.enable()
    on = _drive(s_on, "step", chunks, edges)
    spans.disable()
    np.testing.assert_array_equal(np.stack(off), np.stack(on))
    assert s_off.telemetry().replans == s_on.telemetry().replans


@pytest.mark.parametrize("front", ["run", "run_superchunk", "process",
                                   "plain_step"])
def test_telemetry_times_come_from_the_spans_on_every_front(front):
    recs, chunks, edges = _stream()
    superchunk = 4 if front == "run_superchunk" else 1

    def drive():
        s = _session(superchunk=superchunk,
                     monitor=front != "plain_step")
        if front.startswith("run"):
            return s.run(recs)
        if front == "plain_step":
            for c, e in zip(chunks, edges):
                s.step(c, *e)
            return s.telemetry()
        rng = np.random.default_rng(5)
        n = 600
        ts = np.sort(rng.uniform(0, 12, n)).astype(np.float32)
        tid = rng.integers(0, 3, n).astype(np.int32)
        attr = rng.normal(size=(n, 1)).astype(np.float32)
        keys = rng.integers(0, 50, n)
        for t0 in range(12):
            m = (ts > t0) & (ts <= t0 + 1)
            s.process(tid[m], ts[m], attr[m], keys[m], t0, t0 + 1)
        return s.telemetry()

    off = drive()
    assert off.engine_time_s == 0.0 and off.control_time_s == 0.0
    spans.enable()
    on = drive()
    spans.disable()
    got, _ = spans.drain()
    assert on.matches == off.matches
    total = {n: sum(r.end_ns - r.start_ns for r in got if r.name == n)
             * 1e-9 for n in ("cep.engine", "cep.control")}
    assert on.engine_time_s == pytest.approx(total["cep.engine"])
    assert on.engine_time_s > 0.0
    assert on.control_time_s == pytest.approx(total["cep.control"])
    if front != "plain_step":
        assert on.control_time_s > 0.0


def test_upload_span_holds_its_host_op_on_the_profile_clock(monkeypatch):
    """The chunk's upload, marked by a profiler range inside
    ``FleetEngine._chunk``, lies inside its ``cep.upload`` span once the
    span is put on the profile's clock through ``trace_start_ns``."""
    _, chunks, edges = _stream()
    s = _session()
    s.step(chunks[0], *edges[0])
    inner = FleetEngine._chunk

    def marked(self, c):
        with record_function("probe.chunk_upload"):
            return inner(self, c)
    monkeypatch.setattr(FleetEngine, "_chunk", marked)
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for c, e in zip(chunks[1:5], edges[1:5]):
            s.step(c, *e)
    spans.disable()
    recs, _ = spans.drain()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ups = [((r.start_ns - t0) / 1e3, (r.end_ns - t0) / 1e3) for r in recs
           if r.name == "cep.upload"]
    probes = [e.time_range for e in prof.events()
              if e.name == "probe.chunk_upload"]
    assert len(probes) == len(ups) == 4
    tol_us = 100.0
    for (a, b), p in zip(ups, sorted(probes, key=lambda t: t.start)):
        assert a - tol_us <= p.start <= p.end <= b + tol_us, (a, b, p)


def test_recorder_caps_what_it_keeps_and_counts_the_rest():
    rec = spans.Recorder(cap=3)
    rec.enable()
    for _ in range(2):
        with rec.span("cep.call") as outer:
            with rec.span("cep.engine"):
                pass
    assert outer.seconds > 0.0
    got, dropped = rec.drain()
    assert [r.name for r in got] == ["cep.call", "cep.engine", "cep.call"]
    assert [r.parent for r in got] == [-1, 0, -1]
    assert [r.call for r in got] == [0, 0, 1]
    assert dropped == 1
    assert rec.drain() == ([], 0)
    rec.disable()
    with rec.span("x") as off:
        pass
    assert off.seconds == 0.0 and rec.drain() == ([], 0)


def test_a_span_open_across_a_drain_is_left_out():
    rec = spans.Recorder()
    rec.enable()
    with rec.span("cep.call"):
        with rec.span("cep.engine"):
            pass
        first, _ = rec.drain()
        with rec.span("cep.control"):
            pass
    second, _ = rec.drain()
    assert [(r.name, r.parent) for r in first] == [("cep.engine", -1)]
    assert [(r.name, r.parent) for r in second] == [("cep.control", -1)]
