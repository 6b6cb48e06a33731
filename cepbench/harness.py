"""One run of one benchmark cell: set-up, warm-up, the measured window, the
output check and the metrics.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix and the metrics it reports;
``configs/<config>.json`` holds the configuration as it is run,
``traffic/<traffic>.json`` the mix, ``metrics/<metric>.py`` a per-layer
metric's reader.  The configuration names its pattern set
(``patterns/<set>.py``: the plain description and the program's pattern)
and its plain reference (``references/<reference>.py``); the mix names
the program's entry it drives (``calls/<call>.py``: how a session is
opened and how a batch of chunks is handed to it).  Adding a cell, a
configuration, a pattern set, an entry or a metric adds files and
entries; it edits none of these modules.

A metric reader is a module with ``read(run) -> float | None`` and, if it
must see the program's calls, ``install(run) -> undo``; ``run`` is the
``Traced`` record of the stretch below.  A reader that finds nothing to
read returns None and its metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import trace as tracemod
from .pool import Pool, make_pool

HERE = Path(__file__).resolve().parent
GIB = float(2 ** 30)


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "cepbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names, loaded."""

    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def reference(self):
        return load_module(self.root / "references"
                           / f"{self.config['reference']}.py")

    def patterns(self):
        """The pattern set's module: ``plain(spec)``, ``program(plain)``."""
        return load_module(self.root / "patterns"
                           / f"{self.config['pattern']['set']}.py")

    def calls(self):
        """The entry's module: ``chunks_per_call(traffic)``,
        ``open_session(cell, pattern, device)``, ``prepare(batch)`` and
        ``call(session, args) -> (chunks, K)`` counts on the host."""
        return load_module(self.root / "calls" / f"{self.traffic['call']}.py")

    def plain_pattern(self) -> dict:
        return self.patterns().plain(self.config["pattern"])

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        config=load_json(root / "configs" / f"{w['config']}.json"),
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


def open_cep_session(cell: Cell, pattern, device: str):
    """``repro_torch.cep.open`` as the configuration states it, with the
    mix's window length."""
    from repro_torch import cep
    from repro_torch.cep import RuntimeConfig

    s = cell.config["session"]
    rc = RuntimeConfig(device=device,
                       superchunk=int(cell.traffic.get("superchunk", 1)),
                       **s["runtime"])
    return cep.open(pattern, partitions=int(s["partitions"]),
                    plan=s["plan"], monitor=bool(s["monitor"]), config=rc)


class Driver:
    """Hands the pool to the session through the mix's entry
    (``calls/<call>.py``), ``chunks_per_call`` chunks a call, and keeps
    every answer with its latency."""

    def __init__(self, session, pool: Pool, calls, traffic: dict,
                 sync: Callable):
        self.session = session
        self.pool = pool
        self.calls = calls
        self.per_call = int(calls.chunks_per_call(traffic))
        self.sync = sync
        self.next = 0                       # next replay step
        self.answers: List[np.ndarray] = []  # (K,) per chunk, in order
        self.events = pool.events()

    def step(self):
        """One call: returns (chunks, events, seconds from hand-off to
        the counts on the host)."""
        i, n = self.next, self.per_call
        args = self.calls.prepare([self.pool.step(i + q) for q in range(n)])
        t = time.perf_counter()
        out = self.calls.call(self.session, args)
        dt = time.perf_counter() - t
        self.answers.extend(np.asarray(out, np.int64))
        self.next += n
        ev = int(sum(self.events[(i + q) % self.pool.chunks]
                     for q in range(n)))
        return n, ev, dt


# ---------------------------------------------------------------------------
# The output check
# ---------------------------------------------------------------------------


def expected_answers(cell: Cell, plain: dict, pool: Pool, n: int, device,
                     precision: str = "exact") -> np.ndarray:
    """The reference's counts for replay steps ``0 .. n-1``, ``(n, K)``."""
    steady, head = cell.reference().position_counts(
        plain, pool, device=device, precision=precision)
    idx = np.arange(n)
    pos, cycle = idx % pool.chunks, idx // pool.chunks
    out = steady[pos]
    first = (cycle == 0) & (pos < head.shape[0])
    out[first] = head[pos[first]]
    return out


def compare(answers: np.ndarray, expected: np.ndarray) -> np.ndarray:
    """Per chunk: True where any partition's count differs."""
    return (answers != expected).any(axis=1)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Traced:
    """What a per-layer reader reads: the traced stretch's chunks, the
    program's counters before and after it, the profile (None where the
    device has none) and what installed hooks recorded."""

    chunks: int
    counters: Dict[str, float]
    trace: Optional[tracemod.Trace]
    hooks: Dict[str, list]


def _counters(session) -> Dict[str, float]:
    from repro_torch.core import scan

    tel = session.telemetry()
    out = {f"telemetry.{f}": float(getattr(tel, f)) for f in
           ("replans", "violations", "host_syncs", "overflow", "dropped",
            "escalations", "chunks")}
    out.update({f"scan.{k}": float(v) for k, v in scan.COUNTS.items()})
    return out


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Set up, warm up, measure, check; returns the result line's fields
    (``checks`` last) and the diagnostics for standard error."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    plain = cell.plain_pattern()
    pattern = cell.patterns().program(plain)
    pool = make_pool(cell.config, int(cell.traffic["pool_chunks"]), seed)
    calls = cell.calls()
    session = calls.open_session(cell, pattern, device)
    drv = Driver(session, pool, calls, cell.traffic, sync)

    from repro_torch.core import scan
    scan.reset_counts()
    warm = int(cell.traffic["warmup_chunks"])
    while drv.next < warm:
        drv.step()
    sync()
    # What set-up made lives for the whole run: keep the collector from
    # walking it again and again inside the window.
    gc.collect()
    gc.freeze()
    captures_warm = scan.COUNTS["captures"]
    setup_s = time.perf_counter() - t_start

    win_chunks = win_events = 0
    latencies: List[float] = []
    traced = None
    first_step = drv.next
    if trace:
        traced, wall = _traced_stretch(cell, drv, session, cuda)
        win_chunks = drv.next - first_step
        win_events = int(sum(drv.events[i % pool.chunks]
                             for i in range(first_step, drv.next)))
    else:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            n, ev, dt = drv.step()
            win_chunks += n
            win_events += ev
            latencies.extend([dt] * n)
        sync()
        wall = time.perf_counter() - t
    captures_window = scan.COUNTS["captures"] - captures_warm
    last_t1 = pool.edges(drv.next - 1)[1]

    gc.unfreeze()
    counters = _counters(session)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del session, drv.session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    answers = np.stack(drv.answers)
    expected = expected_answers(cell, plain, pool, len(answers), device)
    wrong = compare(answers, expected)
    check_s = time.perf_counter() - t
    failed = int(wrong[first_step:].sum())
    limit_t = pool.exact_until - plain["window"]
    checks = {
        "mismatched_chunks": [int(wrong.sum()), 0],
        "overflow": [int(counters["telemetry.overflow"]), 0],
        "dropped": [int(counters["telemetry.dropped"]), 0],
        "last_t1": [last_t1, limit_t],
    }
    correct = (checks["mismatched_chunks"][0] == 0
               and checks["overflow"][0] == 0 and checks["dropped"][0] == 0
               and last_t1 < limit_t)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(traced)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {
            "events_per_s": win_events / wall,
            "result_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
            "peak_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win_chunks),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and traced.trace is not None:
        dev["busy_s"] = traced.trace.busy_s
        dev["window_s"] = traced.trace.window_s
        out["breakdown"] = {"device_ops": traced.trace.top_device_ops(),
                            "idle_gaps": traced.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    diag = {"window_s": wall, "window_chunks": win_chunks,
            "window_events": win_events, "answered_chunks": len(answers),
            "matches": int(answers.sum()), "check_s": check_s,
            "captures_in_window": captures_window,
            "escalations": counters["telemetry.escalations"],
            "replans": counters["telemetry.replans"],
            "replays": counters["scan.replays"]}
    return {"line": out, "diag": diag}


def _traced_stretch(cell: Cell, drv: Driver, session, cuda: bool):
    """The traced stretch: ``trace_chunks`` chunks under the profiler (on
    the card) with the readers' hooks installed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    hooks: Dict[str, list] = {}
    run = Traced(chunks=0, counters={}, trace=None, hooks=hooks)
    undo = []
    for m in cell.per_layer:
        mod = cell.reader(m["name"])
        if hasattr(mod, "install"):
            undo.append(mod.install(run))
    before = _counters(session)
    n_target = int(cell.traffic["trace_chunks"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    first = drv.next
    try:
        drv.sync()
        with profile(activities=acts) as prof:
            with record_function(tracemod.WINDOW):
                t = time.perf_counter()
                while drv.next - first < n_target:
                    with record_function(tracemod.CALL):
                        drv.step()
                drv.sync()
                wall = time.perf_counter() - t
    finally:
        for u in reversed(undo):
            if u is not None:
                u()
    after = _counters(session)
    run.chunks = drv.next - first
    run.counters = {k: after[k] - before.get(k, 0.0) for k in after}
    run.trace = tracemod.Trace(prof) if cuda else None
    return run, wall
