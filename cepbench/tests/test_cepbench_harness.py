"""One run of a cell, on the CPU at a tiny size: the result line, cells and
metrics found by name, and runs with the timed path broken underneath."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _tiny import REPO, tiny_bench, tiny_cell
from cepbench.control import control_readings
from cepbench.harness import find_cell, run_cell
from cepbench.run import forbidden_modules

SEED = 2 ** 31 + 12345
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(cell, trace=False, seconds=1.5):
    return run_cell(cell, seed=SEED, seconds=seconds, trace=trace,
                    device="cpu")["line"]


@pytest.mark.parametrize("traffic", ["closed-chunk", "closed-window8"])
def test_line_has_the_contract_keys_and_is_correct(tmp_path, traffic):
    cell = tiny_cell(tmp_path, traffic=traffic)
    line = run(cell)
    assert list(line) == LINE_KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"}
               for c in line["checks"].values())
    json.dumps(line)


def test_tree_plan_cell_is_correct(tmp_path):
    cell = tiny_cell(tmp_path, config="stocks-seq6-tree", size=3,
                     match_capacity=4096)
    line = run(cell, seconds=1.0)
    assert line["correct"] is True, line["checks"]


def test_throwaway_cell_config_and_metric_found_by_name(tmp_path):
    """A new cell, configuration and per-layer metric are files and
    entries; nothing of the harness is edited."""
    metric = {"name": "chunks_seen", "unit": "chunks", "better": "higher",
              "source": "program_counter", "layer": "session front",
              "moves": "events_per_s", "workloads": ["tiny"]}
    cell = tiny_cell(tmp_path, extra_metrics=[metric])
    (tmp_path / "metrics" / "chunks_seen.py").write_text(
        "def read(run):\n    return run.chunks\n")
    line = run(cell, trace=True)
    assert line["metrics"]["chunks_seen"] == {"value": 4.0,
                                             "unit": "chunks"}
    assert line["correct"] is True
    # readers of the device's trace find nothing to read on the CPU
    assert "device_idle_pct" not in line["metrics"]
    with pytest.raises(KeyError):
        find_cell({"workloads": []}, "nope")


AND_SET = """
def plain(spec):
    n = int(spec["size"])
    return {"operator": "AND", "types": list(range(n)),
            "window": float(spec["window"]), "predicates": []}


def program(plain):
    from repro_torch.core.patterns import and_pattern
    return and_pattern(plain["types"], plain["window"])
"""

AND_REFERENCE = """
import itertools, math
import numpy as np


def _counts(plain, pool, j, wrap):
    w, dur = plain["window"], pool.duration
    t0, t1 = j * dur, (j + 1) * dur
    parts = []
    for idx in range(j - int(math.ceil(w / dur)), j + 1):
        shift = 0.0
        if idx < 0:
            if not wrap:
                continue
            idx, shift = idx + pool.chunks, -pool.span
        parts.append((idx, shift))
    out = []
    for k in range(pool.partitions):
        tid = np.concatenate([pool.type_id[i, k][pool.valid[i, k]]
                              for i, _ in parts])
        ts = np.concatenate([pool.ts[i, k][pool.valid[i, k]]
                             .astype(np.float64) + s for i, s in parts])
        by = [ts[(tid == t) & (ts > t0 - w)] for t in plain["types"]]
        n = 0
        for combo in itertools.product(*by):
            hi, lo = max(combo), min(combo)
            n += bool(t0 < hi <= t1 and hi - lo < w)
        out.append(n)
    return out


def position_counts(plain, pool, *, device="cpu", precision="exact"):
    hist = int(math.ceil(plain["window"] / pool.duration))
    steady = np.array([_counts(plain, pool, j, True)
                       for j in range(pool.chunks)], np.int64)
    head = np.array([_counts(plain, pool, j, False)
                     for j in range(min(hist, pool.chunks))], np.int64)
    return steady, head
"""

PAIR_CALL = """
from cepbench.harness import open_cep_session


def chunks_per_call(traffic):
    return 2


def open_session(cell, pattern, device):
    return open_cep_session(cell, pattern, device)


def prepare(batch):
    from repro_torch.core.engine import Chunk
    return [(Chunk(*a), t0, t1) for a, (t0, t1) in batch]


def call(session, args):
    import numpy as np
    return np.stack([session.step(*a) for a in args])
"""


@pytest.mark.parametrize("call", ["step", "step_pairs"])
def test_throwaway_pattern_set_and_entry_found_by_name(tmp_path, call):
    """A pattern set that is no SEQ, its reference and a new entry of the
    program are files in a benchmark root of their own; nothing of the
    harness is edited, and the run is held to that reference."""
    cell = tiny_cell(tmp_path, size=3, n_types=3, partitions=2,
                     chunk_cap=24)
    (tmp_path / "patterns" / "and_any.py").write_text(AND_SET)
    (tmp_path / "references" / "and_brute.py").write_text(AND_REFERENCE)
    (tmp_path / "calls" / "step_pairs.py").write_text(PAIR_CALL)
    cfg = json.loads((tmp_path / "configs" / "tiny.json").read_text())
    cfg["pattern"] = {"set": "and_any", "size": 3, "window": 2.0}
    cfg["reference"] = "and_brute"
    cfg["stream"]["base_rate"] = 6.0
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((tmp_path / "traffic" / "tiny.json").read_text())
    traffic["call"] = call
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    cell = find_cell(tiny_bench(), "tiny", root=tmp_path)
    assert cell.plain_pattern()["operator"] == "AND"
    res = run_cell(cell, seed=SEED, seconds=1.0, trace=False, device="cpu")
    line = res["line"]
    assert line["correct"] is True, line["checks"]
    assert res["diag"]["matches"] > 0
    assert line["attempted"] % (2 if call == "step_pairs" else 1) == 0


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.cep", "reprox", "jax_like",
            "benchmarks_torch", "repro.core", "jaxlib.xla", "flax",
            "benchmarks.torch_common"]
    assert forbidden_modules(mods) == ["benchmarks.torch_common", "flax",
                                       "jaxlib.xla", "repro.core"]


def _stale_state(monkeypatch):
    from repro_torch.core.fleet import FleetEngine

    inner = FleetEngine.process_chunk_monitored

    def stale(self, state, monitor, *a, **kw):
        return (state,) + tuple(inner(self, state, monitor, *a, **kw)[1:])
    monkeypatch.setattr(FleetEngine, "process_chunk_monitored", stale)


def _half_batch(monkeypatch):
    from repro_torch.core.fleet import FleetEngine

    inner = FleetEngine.process_chunk_monitored

    def half(self, state, monitor, chunks, *a, **kw):
        valid = np.array(chunks.valid)
        valid[valid.shape[0] // 2:] = False
        return inner(self, state, monitor, chunks._replace(valid=valid),
                     *a, **kw)
    monkeypatch.setattr(FleetEngine, "process_chunk_monitored", half)


def _altered_answer(monkeypatch):
    from repro_torch.serving.engine import MonitoredCEPFleetServingEngine

    inner = MonitoredCEPFleetServingEngine.process_chunk

    def altered(self, *a, **kw):
        out = inner(self, *a, **kw).copy()
        out[0] += 1
        return out
    monkeypatch.setattr(MonitoredCEPFleetServingEngine, "process_chunk",
                        altered)


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _altered_answer])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    cell = tiny_cell(tmp_path)
    fault(monkeypatch)
    line = run(cell)
    assert line["correct"] is False
    assert line["checks"]["mismatched_chunks"]["value"] > 0
    assert line["failed"] > 0


def test_bfloat16_control_is_not_correct(tmp_path):
    cell = tiny_cell(tmp_path, config="stocks-seq6-tree", partitions=8)
    readings = control_readings(cell, [5, 6, 7], device="cpu")
    assert all(r["mismatched_chunks"] > 0 for r in readings), readings


def _cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "cepbench.run", "--workload",
         "traffic-order-chunk", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _cli(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_cli_needs_more_than_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "cepbench", tmp_path / "cepbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout


@pytest.mark.gpu
def test_cli_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _cli(REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
