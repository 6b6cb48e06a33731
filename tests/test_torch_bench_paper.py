"""The port's paper harnesses (``benchmarks/torch_common.py``,
``torch_fig5_distance``, ``torch_fig69_methods``, ``torch_table1_davg``,
``torch_adaptive_moe``) against the JAX harnesses, at a cut.

One JAX subprocess (started for the module while the twins run with
``--device cpu``) runs the JAX harness functions at the same cut: size 3,
10 chunks, the quick combos with the fig5 grid [0, 0.2, 0.4] and the
fig69 set seq under a fixed d_opt, four more ``run_one`` runs (zstream
on kleene and conj, greedy on the composite and on neg), ``measure_d_avg``
for one greedy and one zstream combo, and the MoE placement policies
over 60 steps of drifting loads.

Held equal exactly: ``events``, ``matches``, ``pm_created``, ``replans``,
``deployments`` and ``false_positives`` of every ``BenchResult``, the
MoE policies' replans, deployments, mean imbalance and final placement.
``d_avg`` equal within ``D_AVG_TOL`` (1e-6).  Timing fields are printed
and never compared.  The ``gpu`` cases run each twin's ``--quick`` on the
card against ``--device cpu``.
"""

import json
import sys

import pytest
import torch

from _torch_dist import ROOT, finish_jax, start_jax

sys.path.insert(0, ROOT)
from benchmarks import (torch_adaptive_moe, torch_common,
                        torch_fig5_distance, torch_fig69_methods,
                        torch_table1_davg)  # noqa: E402

SIZE, CHUNKS, MOE_STEPS = 3, 10, 60
D_AVG_TOL = 1e-6
D_OPT = {"traffic/greedy/3": 0.1, "stocks/greedy/3": 0.3}
ONE = (("stocks", "zstream", "kleene"), ("traffic", "zstream", "conj"),
       ("traffic", "greedy", "composite"), ("stocks", "greedy", "neg"))
D_AVG = (("traffic", "greedy"), ("stocks", "zstream"))
COUNT = torch_common.COUNT_FIELDS

JAX_CODE = """
import numpy as np
from benchmarks import adaptive_moe as am
from benchmarks.common import run_one
from benchmarks.table1_davg import measure_d_avg

res = {}


def put(tag, r):
    res[tag] = np.array([getattr(r, f) for f in COUNT], dtype=np.int64)


for ds, al in (("traffic", "greedy"), ("stocks", "greedy")):
    for d in (0.0, 0.2, 0.4):
        put(f"fig5/{ds}/{al}/{d}", run_one(ds, al, "seq", SIZE, "invariant",
                                           d=d, n_chunks=CHUNKS))
    for s in ("seq",):
        for pol in ("static", "unconditional", "threshold", "invariant"):
            d = D_OPT.get(f"{ds}/{al}/{SIZE}", 0.2)
            put(f"fig69/{ds}/{al}/{s}/{pol}",
                run_one(ds, al, s, SIZE, pol, d=d, n_chunks=CHUNKS))
for ds, al, s in ONE:
    put(f"one/{ds}/{al}/{s}", run_one(ds, al, s, SIZE, "invariant", d=0.1,
                                      n_chunks=CHUNKS))
for ds, al in D_AVG:
    res[f"davg/{ds}/{al}"] = np.float64(measure_d_avg(ds, al, SIZE,
                                                      n_chunks=CHUNKS))

# The MoE policies: the last LPT placement (unconditional, threshold) and
# the governor's (invariant) are recorded around the harness's calls.
rec = {}
real_lpt = am.lpt_placement


def lpt(loads, groups):
    out = real_lpt(loads, groups)
    rec["last"] = out[0]
    return out


class Gov(am.ExpertPlacementGovernor):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        rec["gov"] = self


am.lpt_placement, am.ExpertPlacementGovernor = lpt, Gov
for regime in ("traffic", "stocks"):
    for policy in ("unconditional", "threshold", "invariant"):
        rng = np.random.default_rng(0)
        seq = list(am.drifting_loads(rng, 64, MOE_STEPS, regime))
        r, dep, imb = am.run_policy(policy, seq, 64, 16)
        groups = (rec["gov"].placement.groups if policy == "invariant"
                  else rec["last"].groups)
        res[f"moe/{regime}/{policy}"] = np.array([r, dep], dtype=np.int64)
        res[f"moe/{regime}/{policy}/imb"] = np.float64(imb)
        res[f"moe/{regime}/{policy}/groups"] = np.array(groups)
np.savez(OUT, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def counts(row):
    """A BenchResult (or its JSON dict) as its clock-free fields."""
    get = row.get if isinstance(row, dict) else \
        (lambda f: getattr(row, f))
    return [int(get(f)) for f in COUNT]


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("paper")
    out = str(d / "jax.npz")
    consts = (f"SIZE, CHUNKS, MOE_STEPS = {SIZE}, {CHUNKS}, {MOE_STEPS}\n"
              f"COUNT = {COUNT!r}\nD_OPT = {D_OPT!r}\nONE = {ONE!r}\n"
              f"D_AVG = {D_AVG!r}\n")
    proc = start_jax(consts + JAX_CODE, 1, out)
    cut = ["--device", "cpu", "--sizes", str(SIZE), "--chunks", str(CHUNKS)]
    got = {}
    try:
        fig5 = str(d / "fig5.json")
        got["fig5_ret"] = torch_fig5_distance.main(cut + ["--quick", "--out",
                                                          fig5])
        got["fig5"] = load(fig5)
        dopt = str(d / "dopt.json")
        with open(dopt, "w") as f:
            json.dump(D_OPT, f)
        fig69 = str(d / "fig69.json")
        torch_fig69_methods.main(cut + ["--quick", "--sets", "seq",
                                        "--d-opt", dopt, "--out", fig69])
        got["fig69"] = load(fig69)
        got["one"] = {(ds, al, s): torch_common.run_one(
            ds, al, s, SIZE, "invariant", d=0.1, n_chunks=CHUNKS,
            device="cpu") for ds, al, s in ONE}
        table1 = str(d / "table1.json")
        torch_table1_davg.main(["--device", "cpu", "--quick", "--sizes",
                                str(SIZE), "--chunks", str(CHUNKS),
                                "--d-opt", dopt, "--out", table1])
        got["table1"] = load(table1)
        got["davg"] = {(ds, al): torch_table1_davg.measure_d_avg(
            ds, al, SIZE, CHUNKS, device="cpu") for ds, al in D_AVG}
        moe = str(d / "moe.json")
        torch_adaptive_moe.main(["--device", "cpu", "--steps",
                                 str(MOE_STEPS), "--out", moe])
        got["moe"] = load(moe)
    finally:
        want = finish_jax(proc, out)
    return got, want


def test_run_one_counts_match_jax(runs):
    """``torch_common.run_one`` on zstream (kleene, conj), greedy on neg
    and the greedy composite (three branches under ``merge_metrics``)."""
    got, want = runs
    for (ds, al, s), r in got["one"].items():
        assert counts(r) == want[f"one/{ds}/{al}/{s}"].tolist(), (ds, al, s)
        assert r.events > 0 and r.wall_s > 0
        print(r.row())


def test_fig5_rows_and_d_opt_match_jax(runs):
    got, want = runs
    doc = got["fig5"]
    rows = doc["rows"]
    assert [(r["dataset"], r["algo"], r["d"]) for r in rows] == [
        (ds, "greedy", d) for ds in ("traffic", "stocks")
        for d in (0.0, 0.2, 0.4)]
    for r in rows:
        assert counts(r) == \
            want[f"fig5/{r['dataset']}/{r['algo']}/{r['d']}"].tolist(), r
        print(r["dataset"], r["algo"], r["d"], r["throughput"])
    # d_opt: the fastest d per (combo, size), by the run's own clock.
    keys = {k for k in doc if "/" in k}
    assert keys == {"traffic/greedy/3", "stocks/greedy/3"}
    for key in keys:
        ds, al, _ = key.split("/")
        best = max((r for r in rows if (r["dataset"], r["algo"]) == (ds, al)),
                   key=lambda r: r["throughput"])
        assert doc[key] == best["d"]
    assert got["fig5_ret"] == {k: doc[k] for k in keys}
    assert doc["device"] == {"torch": "cpu", "name": "cpu",
                             "power.limit": "cpu"}


def test_fig69_methods_match_jax(runs):
    got, want = runs
    doc = got["fig69"]
    rows = doc["rows"]
    assert len(rows) == 2 * 4
    for r in rows:
        tag = f"fig69/{r['dataset']}/{r['algo']}/{r['pattern_set']}/" \
              f"{r['policy']}"
        assert counts(r) == want[tag].tolist(), tag
        want_d = D_OPT[f"{r['dataset']}/{r['algo']}/3"] \
            if r["policy"] == "invariant" else 0.0
        assert r["d"] == want_d
    # Detection does not depend on the method.
    for ds in ("traffic", "stocks"):
        for s in ("seq",):
            assert len({r["matches"] for r in rows
                        if (r["dataset"], r["pattern_set"]) == (ds, s)}) == 1
    assert len(doc["gain_over_static"]) == 2
    for g in doc["gain_over_static"]:
        assert set(g) >= {"unconditional", "threshold", "invariant"}


def test_table1_d_avg_matches_jax(runs):
    """d_avg within D_AVG_TOL; the quality is min(d_avg/d_opt, d_opt/d_avg)
    against the d_opt file's value."""
    got, want = runs
    (row,) = got["table1"]["rows"]
    assert (row["dataset"], row["algo"], row["size"]) == ("traffic",
                                                          "greedy", 3)
    assert abs(row["d_avg"] - float(want["davg/traffic/greedy"])) \
        <= D_AVG_TOL
    assert row["d_opt"] == D_OPT["traffic/greedy/3"]
    assert row["quality"] == pytest.approx(
        min(row["d_avg"] / row["d_opt"], row["d_opt"] / row["d_avg"]))
    for (ds, al), v in got["davg"].items():
        assert abs(v - float(want[f"davg/{ds}/{al}"])) <= D_AVG_TOL, (ds, al)
        assert v > 0


def test_adaptive_moe_policies_match_jax(runs):
    got, want = runs
    rows = got["moe"]["rows"]
    assert len(rows) == 6
    for r in rows:
        tag = f"moe/{r['regime']}/{r['policy']}"
        assert [r["replans"], r["deployments"]] == want[tag].tolist(), tag
        assert r["avg_imbalance"] == pytest.approx(
            float(want[f"{tag}/imb"]), rel=1e-12)
        assert r["groups"] == want[f"{tag}/groups"].tolist(), tag
    inv = [r for r in rows if r["policy"] == "invariant"]
    unc = [r for r in rows if r["policy"] == "unconditional"]
    assert all(a["replans"] < b["replans"] for a, b in zip(inv, unc))


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_adaptive_moe.main(["--steps", "2", "--out",
                                 str(tmp_path / "m.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_common.run_one("traffic", "greedy", "seq", 3, "static",
                             n_chunks=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    return "cuda"


def _quick_docs(mod, tmp_path, extra=()):
    """The twin's ``--quick`` JSON on the card and on the CPU."""
    docs = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.json")
        mod.main(["--quick", "--device", dev, "--out", out, *extra])
        docs[dev] = load(out)
    return docs


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fig5", "fig69", "table1", "moe"])
def test_cuda_quick_equals_cpu(cuda_device, name, tmp_path):
    """Each paper twin's ``--quick`` path on the card gives the CPU run's
    clock-free fields (fig69 and table1 under one fixed d_opt file)."""
    dopt = str(tmp_path / "dopt.json")
    with open(dopt, "w") as f:
        json.dump({"traffic/greedy/4": 0.1, "stocks/greedy/4": 0.2}, f)
    mod = {"fig5": torch_fig5_distance, "fig69": torch_fig69_methods,
           "table1": torch_table1_davg, "moe": torch_adaptive_moe}[name]
    extra = ["--d-opt", dopt] if name in ("fig69", "table1") else []
    docs = _quick_docs(mod, tmp_path, extra)
    card, cpu = docs["cuda"]["rows"], docs["cpu"]["rows"]
    assert len(card) == len(cpu) > 0
    for a, b in zip(card, cpu):
        if name in ("fig5", "fig69"):
            assert counts(a) == counts(b), a
        elif name == "table1":
            assert abs(a["d_avg"] - b["d_avg"]) <= D_AVG_TOL
        else:
            assert a == b
    assert docs["cuda"]["device"]["torch"].startswith("cuda")
    assert docs["cuda"]["device"]["power.limit"]
