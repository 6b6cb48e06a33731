"""The readers of the program's own spans (``cepbench/spans.py`` and the
five ``metrics/`` that use it), on hand-made ``Traced`` records and on a
tiny traced cell, on the CPU."""

import sys

import pytest
import torch

from _tiny import tiny_cell
from cepbench.harness import HERE, Traced, load_module, run_cell
from cepbench import span_split
from cepbench.spans import KEY, idle_us, install, overlap_us, self_ms
from repro_torch.core import spans as recorder
from repro_torch.core.spans import Span

SPAN_METRICS = ("control_ms_per_chunk", "planner_ms_per_flag",
                "upload_ms_per_chunk", "readback_wait_ms_per_chunk",
                "control_idle_pct")
T0 = 5_000_000_000  # the profile's trace_start_ns
US = 1000            # ns


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py")


class FakeTrace:
    """The part of ``cepbench.trace.Trace`` the readers use: the stretch
    [0, 100] us, the device busy in [10, 30] and [50, 60], four top-level
    host ops."""

    start_us, end_us = 0.0, 100.0
    window_s, busy_s = 100e-6, 30e-6
    device_ops = [("k", 10.0, 30.0), ("k", 50.0, 60.0)]
    _host = [("aten::to", 1.0, 3.0), ("aten::copy_", 12.0, 18.0),
             ("aten::to", 25.0, 32.0), ("aten::copy_", 34.0, 38.0)]

    def busy_intervals(self):
        return [[10.0, 30.0], [50.0, 60.0]]


def span(name, a_us, b_us, parent=-1, call=0):
    return Span(name, T0 + a_us * US, T0 + b_us * US, parent, call)


# Two calls: the first with an engine (upload, readback) and a control
# span holding one flag's statistic read, planner and lowering; the
# second's control span runs past the stretch's end.
SPANS = [
    span("cep.call", 0, 80),
    span("cep.engine", 0, 20, parent=0),
    span("cep.upload", 0, 4, parent=1),
    span("cep.readback", 12, 20, parent=1),
    span("cep.control", 20, 55, parent=0),
    span("cep.stat_read", 21, 23, parent=4),
    span("cep.plan", 23, 33, parent=4),
    span("cep.lower", 33, 40, parent=4),
    span("cep.call", 85, 130, call=1),
    span("cep.control", 90, 120, parent=8, call=1),
]


def traced(spans=SPANS, trace=None, flags=2, start=T0, chunks=2):
    hooks = {KEY: {"users": 0, "spans": spans, "dropped": 0,
                   "trace_start_ns": start}}
    return Traced(chunks=chunks, counters={"telemetry.violations": flags},
                  trace=trace, hooks=hooks)


def test_interval_arithmetic():
    busy = [[10.0, 30.0], [50.0, 60.0]]
    assert overlap_us([[0, 15], [25, 55]], busy) == 5 + 5 + 5
    # control [20, 55] is idle in [30, 50]; [90, 120] is clipped to
    # [90, 100], all idle; nested or overlapping spans count once
    assert idle_us([(20, 55), (90, 120)], busy, 0.0, 100.0) == 30.0
    assert idle_us([(20, 55), (25, 40)], busy, 0.0, 100.0) == 20.0
    assert idle_us([(-50, -10)], busy, 0.0, 100.0) == 0.0


def test_readers_on_hand_made_spans():
    run = traced(trace=FakeTrace())
    got = {m: reader(m).read(run) for m in SPAN_METRICS}
    assert got["control_ms_per_chunk"] == pytest.approx((35 + 30) / 1e3 / 2)
    assert got["upload_ms_per_chunk"] == pytest.approx(4 / 1e3 / 2)
    assert got["readback_wait_ms_per_chunk"] == pytest.approx(8 / 1e3 / 2)
    assert got["planner_ms_per_flag"] == pytest.approx(10 / 1e3 / 2)
    assert got["control_idle_pct"] == pytest.approx(30.0)
    device_idle = reader("device_idle_pct").read(run)
    assert got["control_idle_pct"] <= device_idle == pytest.approx(70.0)


def test_self_time_leaves_out_the_children():
    # control [20, 55] holds children over [21, 40]: 16 us of its own
    assert self_ms(SPANS, "cep.control") == pytest.approx((16 + 30) / 1e3)
    assert self_ms(SPANS, "cep.plan") == pytest.approx(10 / 1e3)


def test_span_split_labels_each_idle_instant_by_its_innermost_span():
    """``cepbench.span_split`` on the hand-made spans: the stretch's wall
    and idle time by innermost span (the second call's control clipped at
    the stretch's end), and each host op's idle time by the span it ran
    in; an op that ran only while the device was busy is absent."""
    got = span_split.split(SPANS, T0, FakeTrace())
    wall = {"cep.upload": 4, "cep.engine": 8, "cep.readback": 8,
            "cep.control": 26, "cep.stat_read": 2, "cep.plan": 10,
            "cep.lower": 7, "cep.call": 30, span_split.OUTSIDE: 5}
    idle = {"cep.upload": 4, "cep.engine": 6, "cep.plan": 3,
            "cep.lower": 7, "cep.control": 20, "cep.call": 25,
            span_split.OUTSIDE: 5}
    assert got["wall_s"] == pytest.approx({k: v * 1e-6 for k, v in
                                           wall.items()})
    assert got["idle_s"] == pytest.approx({k: v * 1e-6 for k, v in
                                           idle.items()})
    assert sum(got["idle_s"].values()) == pytest.approx(70e-6)
    ops = {(op, sp): v for op, sp, v in got["op_idle_s"]}
    assert ops == pytest.approx({("aten::to", "cep.upload"): 2e-6,
                                 ("aten::to", "cep.plan"): 2e-6,
                                 ("aten::copy_", "cep.lower"): 4e-6})
    assert got["op_idle_s"][0][:2] == ["aten::copy_", "cep.lower"]


def test_span_split_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert span_split.main(["--workload", "x", "--seed", "1"]) == 2


@pytest.mark.parametrize("case", ["no spans", "no recorder", "no trace",
                                  "no trace start", "no flags"])
def test_nothing_to_read_gives_none(case):
    if case == "no spans":
        run = traced(spans=[], trace=FakeTrace())
    elif case == "no recorder":
        run = Traced(chunks=2, counters={}, trace=FakeTrace(), hooks={})
    elif case == "no trace":
        run = traced(trace=None)
    elif case == "no trace start":
        run = traced(trace=FakeTrace(), start=None)
    else:
        run = traced(trace=FakeTrace(), flags=0)
    got = {m: reader(m).read(run) for m in SPAN_METRICS}
    if case in ("no spans", "no recorder"):
        assert set(got.values()) == {None}
    elif case == "no flags":
        assert got["planner_ms_per_flag"] is None
        assert got["control_ms_per_chunk"] is not None
    else:
        assert got["control_idle_pct"] is None
        assert got["control_ms_per_chunk"] is not None


def test_several_readers_install_one_recorder_and_the_last_undo_drains():
    from torch.profiler import ProfilerActivity, profile

    exit_before = profile.__exit__
    run = Traced(chunks=0, counters={}, trace=None, hooks={})
    undo = [reader(m).install(run) for m in SPAN_METRICS]
    assert recorder._REC.on
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("cep.call"):
            pass
    assert profile.__exit__ is not exit_before
    for u in reversed(undo[1:]):
        u()
        assert recorder._REC.on and run.hooks[KEY]["spans"] == []
    undo[0]()
    assert not recorder._REC.on
    assert profile.__exit__ is exit_before
    st = run.hooks[KEY]
    assert [s.name for s in st["spans"]] == ["cep.call"]
    assert st["dropped"] == 0
    assert st["trace_start_ns"] == \
        prof.profiler.kineto_results.trace_start_ns()
    assert recorder.drain() == ([], 0)


def test_a_program_without_the_recorder_installs_nothing(monkeypatch):
    import repro_torch.core

    monkeypatch.delattr(repro_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    run = Traced(chunks=2, counters={}, trace=FakeTrace(), hooks={})
    assert install(run) is None and run.hooks == {}
    assert {reader(m).read(run) for m in SPAN_METRICS} == {None}


def test_a_traced_tiny_cell_reports_the_span_metrics(tmp_path):
    """On the CPU the four span-only readers read; ``control_idle_pct``
    needs the device's trace and is left out."""
    cell = tiny_cell(tmp_path)
    line = run_cell(cell, seed=2 ** 31 + 12345, seconds=1.0, trace=True,
                    device="cpu")["line"]
    assert line["correct"] is True
    got = {m for m in SPAN_METRICS if m in line["metrics"]}
    assert got == set(SPAN_METRICS) - {"control_idle_pct"}
    assert all(line["metrics"][m]["value"] > 0 for m in got)
    assert not recorder._REC.on
