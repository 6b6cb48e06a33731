"""The port's framework harnesses (``benchmarks/torch_replay_bench.py``,
``torch_fleet_bench``, ``torch_rulebook_bench``, ``torch_kernel_bench``,
``torch_run``) against the JAX harnesses, at a cut.

One JAX subprocess (started for the module while the twins run with
``--device cpu``) runs the JAX harness functions at the same cut:
``replay_bench.run_scenario`` on flowsense (K = 4, negation) with its
segments scaled by ``SCALE``; the fleet bench's facade and monitored sessions
(``_records``, ``_session_pass``) at K = 4 over 8 chunks and its
superchunk sweep (K = 16, 24 chunks, 12 warm) per chunk and in windows;
``rulebook_bench.bench_q``'s rulebook at Q = 4, K = 4 over 6 chunks
(``make_rules``, ``make_chunks``; the port's ``bench_q`` also holds it to
Q sessions), the bench's superchunk
section (warm 8, tail 16) and its hot add (the add and the next step,
without the latency assert, a clock gate); ``kernel_bench._case`` and
``bench_shapes`` at (4, 64, 32).

Held equal exactly: the replay segments' events, matches, replans,
deployments, violations, overflow and escalations, the correctness
gates' booleans and the pinned recall; the fleet configurations' match
counts and timed violations; the per-rule rulebook counts (per chunk, in
windows, after the hot add), replans, violations, overflow,
``sharing_ratio`` and the prefix-mode ratio; the kernel bench's mask,
row counts and record keys.  Timing fields are printed and never
compared.  The ``gpu`` cases run each twin's ``--quick`` on the card
against ``--device cpu`` (the kernel bench against the plain versions on
the card).
"""

import json
import sys

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, finish_jax, start_jax

sys.path.insert(0, ROOT)
from benchmarks import (torch_fleet_bench, torch_kernel_bench,  # noqa: E402
                        torch_replay_bench, torch_rulebook_bench, torch_run)

SCALE = 0.15
SCENARIOS = ("flowsense",)
ROW = ("events", "matches", "replans", "deployments", "violations",
       "overflow", "escalations")
CORRECT = ("zero_control_replans", "detection_invariance",
           "expected_deployments", "pinned_loses_matches",
           "superchunk_control_silent")
FLEET_K, FLEET_CHUNKS, SC_CHUNKS, SC_WARM = 4, 8, 24, 12
RB_Q, RB_K, RB_CHUNKS, RB_WARM, RB_TAIL = 4, 4, 6, 8, 16
KB_SHAPE = (4, 64, 32)

JAX_CODE = """
import dataclasses
import numpy as np
from benchmarks import fleet_bench, kernel_bench, replay_bench, rulebook_bench
from repro import cep
from repro.cep import OrderPlan, RuntimeConfig
from repro.data import scenarios
import repro.cep.rulebook as jrb

res = {}
for name in SCENARIOS:
    r = replay_bench.run_scenario(scenarios.get(name), seed=0, rate=1.0,
                                  chunks_scale=SCALE, superchunk=True)
    for c, rows in r["segments"].items():
        res[f"replay/{name}/{c}"] = np.array(
            [[row[f] for f in ROW] for row in rows], dtype=np.int64)
    res[f"replay/{name}/gates"] = np.array([r["gates"][g] for g in CORRECT])
    res[f"replay/{name}/recall"] = np.float64(r["drift_recall_pinned"])

# fleet_bench.bench_k's facade and monitored sessions at a cut
k = FLEET_K
pat = fleet_bench._pattern()
recs = fleet_bench._records(k, FLEET_CHUNKS, 64)
rcfg = RuntimeConfig(buffer_capacity=32, match_capacity=256, policy=None)
plans = [OrderPlan(((2, 1, 0), (0, 1, 2), (1, 0, 2))[p % 3])
         for p in range(k)]
sess = cep.open(pat, partitions=k, plan="order", config=rcfg)
for p, plan in enumerate(plans):
    sess.deploy(p, plan)
res["fleet/facade"] = fleet_bench._session_pass(sess, recs, k, reps=1)[1]
mon = cep.open(pat, partitions=k, plan="order", monitor=True,
               config=dataclasses.replace(rcfg, policy="invariant",
                                          policy_kw={"k": 1, "d": 0.5}))
for p, plan in enumerate(plans):
    mon.deploy(p, plan)
res["fleet/mon"] = fleet_bench._session_pass(mon, recs, k)[1]
res["fleet/mon_violations"] = np.int64(mon.telemetry().violations)

# fleet_bench.bench_superchunk's sweep at a cut (per chunk, S = 8)
from repro.core.fleet import stacked_streams
from repro.data.cep_streams import StreamConfig, make_stream
scfg = StreamConfig(n_types=3, n_chunks=SC_CHUNKS, chunk_cap=8,
                    base_rate=1.5, seed=3, shift_every=1e9, zipf_s=0.1)
srecs = list(stacked_streams(
    [make_stream("traffic", dataclasses.replace(scfg, seed=3 + p))
     for p in range(16)]))
chunks = [fc.chunk for fc in srecs]
edges = [(fc.t0, fc.t1) for fc in srecs]
scfg_rt = RuntimeConfig(buffer_capacity=8, match_capacity=16,
                        estimator_buckets=64, max_invariants=8,
                        max_terms=16, policy="invariant",
                        policy_kw={"k": 1, "d": 2.0})
w = SC_WARM
for s in (1, 8):
    sc = cep.open(fleet_bench._pattern(), partitions=16, plan="order",
                  monitor=True, config=scfg_rt, superchunk=s)
    if s == 1:
        for ch, (u, v) in zip(chunks[:w], edges[:w]):
            sc.step(ch, u, v)
        v0 = sc.telemetry().violations
        c = np.zeros(16, np.int64)
        for ch, (u, v) in zip(chunks[w:], edges[w:]):
            c += np.asarray(sc.step(ch, u, v))
    else:
        sc.step_superchunk(chunks[:w], edges[:w])
        v0 = sc.telemetry().violations
        c = np.asarray(sc.step_superchunk(chunks[w:], edges[w:])).sum(axis=0)
    res[f"fleet/sc{s}"] = c
    res[f"fleet/sc{s}_violations"] = np.int64(sc.telemetry().violations - v0)

# rulebook_bench.bench_q's rulebook at a cut (its Q-session side, which
# it asserts equal, is left out: the port's bench_q asserts it too)
cfg = RuntimeConfig(buffer_capacity=32, match_capacity=128,
                    estimator_buckets=8)
rules = rulebook_bench.make_rules(RB_Q)
rb_chunks, _ = rulebook_bench.make_chunks(RB_CHUNKS, RB_K)
rb = jrb.open_rulebook(rules, partitions=RB_K, monitor=True, config=cfg,
                       spare_slots=1)
for chunk, t0, t1 in rb_chunks:
    rb.step(chunk, t0, t1)
tel = rb.telemetry()
prefix = jrb.open_rulebook(rules, partitions=RB_K, monitor=False,
                           config=dataclasses.replace(cfg, sharing="prefix"),
                           spare_slots=1).sharing_ratio()
res["rb/counts"] = np.asarray(rb.match_counts)
res["rb/ratios"] = np.array([round(rb.sharing_ratio(), 3), round(prefix, 3)])
res["rb/ints"] = np.array([rb.n_buckets, tel.replans, tel.violations])
made = []
real_open = jrb.open_rulebook


def recording_open(*a, **kw):
    book = real_open(*a, **kw)
    made.append(book)
    return book


jrb.open_rulebook = recording_open
rulebook_bench.bench_superchunk(RB_Q, RB_K, 8, warm=RB_WARM, tail=RB_TAIL)
jrb.open_rulebook = real_open
tel = made[1].telemetry()
res["rb/sc_counts"] = np.asarray(made[1].match_counts)
res["rb/sc_ints"] = np.array([tel.replans, tel.violations, tel.overflow])
# bench_hot_add's add and step (its latency assert is a clock gate)
from repro.cep.dsl import P
pre = rb.trace_count()
chunk, t0, t1 = rb_chunks[-1]
rb.add_rule(P.seq(4, 2, 0).where(P.attr(0, 1) < P.attr(1, 0) + 0.5)
            .within(1.5).attrs(2))
rb.step(chunk, t0 + 1.0, t1 + 1.0)
res["rb/hot_counts"] = np.asarray(rb.match_counts)
res["rb/hot_retraces"] = np.int64(rb.trace_count() - pre)

# kernel_bench at a cut
from repro.kernels import ops
L, R, op, th, mv, bv = kernel_bench._case(np.random.default_rng(0),
                                          *KB_SHAPE)
res["kb/mask"] = np.asarray(ops.window_join_packed(
    L, R, op.astype(np.int8), th, mv, bv))
res["kb/rowcount"] = np.asarray(ops.window_join_rowcount(L, R, op, th))
rows, _ = kernel_bench.bench_shapes([KB_SHAPE], 1, False, ops.get_backend())
res["kb/rows"] = np.array([f"{r['shape']}|{r['config']}|{r['cells']}"
                           for r in rows])
np.savez(OUT, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("framework")
    out = str(d / "jax.npz")
    consts = "".join(f"{k} = {v!r}\n" for k, v in dict(
        SCALE=SCALE, SCENARIOS=SCENARIOS, ROW=ROW, CORRECT=CORRECT,
        FLEET_K=FLEET_K, FLEET_CHUNKS=FLEET_CHUNKS, SC_CHUNKS=SC_CHUNKS,
        SC_WARM=SC_WARM, RB_Q=RB_Q, RB_K=RB_K, RB_CHUNKS=RB_CHUNKS,
        RB_WARM=RB_WARM, RB_TAIL=RB_TAIL, KB_SHAPE=KB_SHAPE).items())
    proc = start_jax(consts + JAX_CODE, 1, out)
    got = {}
    try:
        # replay: main on flowsense (run_scenario under it)
        path = str(d / "scenarios.json")
        replay_runs = {}
        got["replay_rc"] = torch_replay_bench.main(
            ["--scenario", "flowsense", "--chunks-scale", str(SCALE),
             "--device", "cpu", "--no-gate", "--json", path],
            runs=replay_runs)
        got["replay"] = load(path)["scenarios"]
        got["replay_runs"] = replay_runs
        path = str(d / "fleet.json")
        torch_fleet_bench.main(
            ["--ks", str(FLEET_K), "--chunks", str(FLEET_CHUNKS),
             "--superchunk-chunks", str(SC_CHUNKS), "--device", "cpu",
             "--no-gate", "--json", path])
        got["fleet"] = load(path)
        rb, chunks, _, summary = torch_rulebook_bench.bench_q(
            RB_Q, RB_K, RB_CHUNKS, "cpu")
        got["rb"] = summary
        sc, rb_sc, sc_chunks = torch_rulebook_bench.bench_superchunk(
            RB_Q, RB_K, 8, RB_WARM, RB_TAIL, "cpu")
        got["rb_sc"] = sc
        got["rb_sc_tel"] = rb_sc.telemetry()
        got["rb_hot"] = torch_rulebook_bench.bench_hot_add(
            rb, chunks, summary["cold_compile_s"], "cpu", rb_sc, sc_chunks)
        got["rb_hot_counts"] = rb.match_counts
        L, R, op, th, mv, bv = (torch.as_tensor(a) for a in
                                torch_kernel_bench._case(
                                    np.random.default_rng(0), *KB_SHAPE))
        from repro_torch.kernels import ops
        got["kb_mask"] = ops.window_join_packed(
            L, R, op.to(torch.int8), th, mv, bv)[0].numpy()
        got["kb_rowcount"] = ops.window_join_rowcount(L, R, op, th)[0].numpy()
        got["kb_rows"] = torch_kernel_bench.bench_shapes([KB_SHAPE], 1,
                                                         "cpu")[0]
    finally:
        want = finish_jax(proc, out)
    return got, want


@pytest.mark.parametrize("name", SCENARIOS)
def test_replay_segments_and_gates_match_jax(runs, name):
    got, want = runs
    res = got["replay"][name]
    for config, rows in res["segments"].items():
        assert [[r[f] for f in ROW] for r in rows] == \
            want[f"replay/{name}/{config}"].tolist(), (name, config)
        print(name, config, [r["wall_s"] for r in rows])
    assert [res["gates"][g] for g in CORRECT] == \
        want[f"replay/{name}/gates"].tolist()
    assert res["drift_recall_pinned"] == float(want[f"replay/{name}/recall"])
    assert res["correctness_pass"] == all(res["gates"][g] for g in CORRECT)
    tput = res["throughput_gates"]["adaptive_ge_static_tput"]
    assert set(tput) == {"value", "threshold", "bound", "met"}
    assert tput["met"] == res["gates"]["adaptive_ge_static_tput"]


def test_replay_main_writes_the_record(runs):
    got, _ = runs
    # --no-gate spares only the throughput gate
    assert got["replay_rc"] == int(
        not got["replay"]["flowsense"]["correctness_pass"])
    assert set(got["replay_runs"]) == {"flowsense"}
    rows = got["replay_runs"]["flowsense"]
    assert set(rows) == set(torch_replay_bench.CONFIGS)
    assert [r[2].matches for r in rows["adaptive"]] == \
        [r["matches"] for r in got["replay"]["flowsense"]["segments"][
            "adaptive"]]


GATES = CORRECT + torch_replay_bench.THROUGHPUT_GATES


@pytest.mark.parametrize("failed, no_gate, rc", [
    (None, False, 0),
    ("detection_invariance", True, 1),
    ("zero_control_replans", False, 1),
    ("adaptive_ge_static_tput", True, 0),
    ("adaptive_ge_static_tput", False, 1)])
def test_replay_exit_code_follows_the_gates(monkeypatch, tmp_path, failed,
                                            no_gate, rc):
    """A failed correctness gate exits 1 under ``--no-gate`` too, which
    spares only a missed throughput gate.  The replays and the gates are
    stubbed, so one gate fails at will; the verdict and the exit code are
    the twin's own."""
    def gates(sc, runs):
        got = {g: g != failed for g in GATES}
        return got, {}, 0.5

    monkeypatch.setattr(torch_replay_bench, "replay",
                        lambda *a, **kw: [])
    monkeypatch.setattr(torch_replay_bench, "scenario_gates", gates)
    path = str(tmp_path / "scenarios.json")
    argv = ["--scenario", "fraud", "--chunks-scale", "0.25", "--passes",
            "1", "--device", "cpu", "--json", path]
    assert torch_replay_bench.main(argv + ["--no-gate"] * no_gate) == rc
    doc = load(path)
    assert doc["all_correctness_pass"] == (failed not in CORRECT)
    assert doc["all_gates_pass"] == (failed is None)


def test_fleet_configs_match_jax(runs):
    got, want = runs
    doc = got["fleet"]
    by = {(r["k"], r["config"]): r for r in doc["rows"]}
    for config in ("baseline", "vmapped", "facade", "monitored"):
        assert by[FLEET_K, config]["matches"] == \
            want["fleet/facade"].tolist(), config
        print(config, by[FLEET_K, config]["seconds"])
    assert want["fleet/mon"].tolist() == want["fleet/facade"].tolist()
    assert by[FLEET_K, "monitored"]["violations"] == \
        int(want["fleet/mon_violations"])
    for config in ("per_chunk_monitored", "scanned", "sharded"):
        assert by[16, config]["matches"] == want["fleet/sc1"].tolist()
    assert want["fleet/sc8"].tolist() == want["fleet/sc1"].tolist()
    sc = doc["superchunk"]
    assert sc["timed_violations"] == int(want["fleet/sc1_violations"]) == \
        int(want["fleet/sc8_violations"])
    assert sc["devices"] == 1
    assert set(doc["gates"]) == {f"facade_overhead_k{FLEET_K}",
                                 f"monitoring_overhead_k{FLEET_K}",
                                 "superchunk_speedup_k16"}
    for name, g in doc["gates"].items():
        # each record holds what decides it: both sweeps and the slack
        assert set(g) == {"value", "threshold", "bound", "seconds", "base_s",
                          "slack_s", "met"}, name
        limit = (g["base_s"] * (1 + g["threshold"]) if g["bound"] == "max"
                 else g["base_s"] / g["threshold"])
        assert g["met"] == (g["seconds"] <= limit + g["slack_s"]), name
    assert doc["device"]["torch"] == "cpu"
    # a run off its mode's grid says so
    assert [doc["ks"], doc["n_chunks"], doc["superchunk_chunks"]] == \
        [[FLEET_K], FLEET_CHUNKS, SC_CHUNKS]
    assert doc["quick"] and not doc["full"] and len(doc["cut"]) == 3


def test_rulebook_counts_and_sharing_match_jax(runs):
    got, want = runs
    s = got["rb"]
    assert s["match_counts"] == want["rb/counts"].tolist()
    assert [s["sharing_ratio"], s["prefix_sharing_ratio"]] == \
        want["rb/ratios"].tolist()
    assert [s["n_buckets"], s["replans"], s["violations"]] == \
        want["rb/ints"].tolist()
    sc, tel = got["rb_sc"], got["rb_sc_tel"]
    assert sc["superchunk_match_counts"] == want["rb/sc_counts"].tolist()
    assert [tel.replans, tel.violations, tel.overflow] == \
        want["rb/sc_ints"].tolist()
    assert [sc["superchunk_replans"], sc["superchunk_violations"],
            sc["superchunk_overflow"]] == want["rb/sc_ints"].tolist()
    # hot add: the per-chunk rulebook's counts after the add and its step
    assert got["rb_hot_counts"].tolist() == want["rb/hot_counts"].tolist()
    assert got["rb_hot"]["retraces"] == int(want["rb/hot_retraces"]) == 0
    assert got["rb_hot"]["captures"] == 0
    print(s["speedup"], sc["superchunk_speedup"], got["rb_hot"]["hot_add_s"])


def test_rulebook_main_gates_at_the_lattice_suite(tmp_path):
    """At Q = 18 the mixed-prefix suite holds a 4-arity family, so the
    lattice shares more than the opening prefix; the throughput gates are
    recorded (value, threshold, met) and, under --no-gate, do not fail."""
    path = str(tmp_path / "rb.json")
    assert torch_rulebook_bench.main(
        ["--qs", "18", "--chunks", "3", "--warm", "8", "--tail", "8",
         "--device", "cpu", "--no-gate", "--json", path]) == 0
    doc = load(path)
    (s,) = doc["summaries"]
    assert s["sharing_ratio"] > s["prefix_sharing_ratio"] > 1.0
    assert set(doc["gates"]) == {"rulebook_speedup_q18",
                                 "superchunk_speedup_q18", "hot_add_latency"}
    assert doc["hot_add"]["retraces"] == doc["hot_add"]["captures"] == 0


def test_kernel_bench_matches_jax(runs, tmp_path):
    got, want = runs
    assert np.array_equal(got["kb_mask"], want["kb/mask"])
    assert np.array_equal(got["kb_rowcount"], want["kb/rowcount"])
    assert [f"{r['shape']}|{r['config']}|{r['cells']}"
            for r in got["kb_rows"]] == want["kb/rows"].tolist()
    assert all(r["perf"] is False for r in got["kb_rows"])
    path = str(tmp_path / "kb.json")
    torch_kernel_bench.main(
        ["--quick", "--shapes", "4,64,32", "--fleet-scale", "64",
         "--windows", "1", "--iters", "2", "--device", "cpu", "--no-gate",
         "--json", path])
    doc = load(path)
    assert doc["sweep"] == "no tunable: strip geometry fixed"
    configs = {r["config"] for r in doc["rows"]}
    assert {"packed_kernel", "rowcount_kernel", "join_kernel",
            "count_kernel", "select_kernel", "scanned"} <= configs
    assert all(r["equal"] for r in doc["rows"] if "equal" in r)
    assert doc["scanned"]["joins_per_chunk"] == 2


def test_torch_run_only(tmp_path, monkeypatch, capsys):
    """``--only`` runs the named twins (their JSON lands under results/);
    an unknown key raises instead of running nothing."""
    monkeypatch.chdir(tmp_path)
    assert torch_run.main(["--only", "table1,roofline", "--device",
                           "cpu"]) == 0
    (row,) = load("results/torch_table1.json")["rows"]
    assert (row["dataset"], row["algo"], row["size"], row["d_opt"]) == \
        ("traffic", "greedy", 4, 0.2)
    with pytest.raises(ValueError, match="unknown key"):
        torch_run.main(["--only", "table1,fig7", "--device", "cpu"])
    torch_run.main(["--summary"])
    assert "no BENCH_torch_*.json artifacts found" in capsys.readouterr().out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    return "cuda"


def _both(fn, tmp_path):
    return {dev: fn(dev, str(tmp_path / f"{dev}.json"))
            for dev in ("cuda", "cpu")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["replay", "fleet", "rulebook", "kernel"])
def test_cuda_quick_equals_cpu(cuda_device, name, tmp_path):
    """Each framework twin's ``--quick`` path on the card gives the CPU
    run's clock-free fields."""
    if name == "replay":
        docs = _both(lambda dev, p: (torch_replay_bench.main(
            ["--quick", "--device", dev, "--no-gate", "--json", p]),
            load(p))[1], tmp_path)
        for sc, res in docs["cuda"]["scenarios"].items():
            ref = docs["cpu"]["scenarios"][sc]
            for config, rows in res["segments"].items():
                assert [[r[f] for f in ROW] for r in rows] == \
                    [[r[f] for f in ROW] for r in ref["segments"][config]]
            assert res["correctness_pass"] and ref["correctness_pass"]
    elif name == "fleet":
        docs = _both(lambda dev, p: (torch_fleet_bench.main(
            ["--device", dev, "--no-gate", "--json", p]), load(p))[1],
            tmp_path)
        assert [r["matches"] for r in docs["cuda"]["rows"]] == \
            [r["matches"] for r in docs["cpu"]["rows"]]
    elif name == "rulebook":
        docs = _both(lambda dev, p: (torch_rulebook_bench.main(
            ["--device", dev, "--no-gate", "--json", p]), load(p))[1],
            tmp_path)
        for a, b in zip(docs["cuda"]["summaries"], docs["cpu"]["summaries"]):
            for key in ("match_counts", "sharing_ratio",
                        "prefix_sharing_ratio", "replans", "violations"):
                assert a[key] == b[key], key
        assert docs["cuda"]["hot_add"]["captures"] == 0
    else:
        # The kernels are held against their plain versions on the card
        # (the CPU's plain versions at the fleet shapes would take hours).
        path = str(tmp_path / "kb.json")
        torch_kernel_bench.main(["--quick", "--device", "cuda", "--no-gate",
                                 "--json", path])
        docs = {"cuda": load(path)}
        rows = [r for r in docs["cuda"]["rows"] if "equal" in r]
        assert len(rows) == 5
        assert all(r["equal"] and r["graph_ms"] > 0 for r in rows)
    assert docs["cuda"]["device"]["torch"].startswith("cuda")
