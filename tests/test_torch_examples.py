"""The seven ``examples/torch_*.py`` twins against the JAX package's
examples, at a cut.

Each twin runs here with ``--device cpu`` and its size flags cut
(``--chunks 30`` for the CEP examples, ``--steps`` for the training
ones), and its printed counts are held against the same calls made
through the JAX package at the same cut (one subprocess, started for the
module while the twins run):

* ``torch_quickstart`` and ``torch_adaptive_cep_demo``: per run, matches,
  partial matches, replans, deployments and false positives equal; the
  quickstart's plan regret and the d_avg estimate as printed;
* ``torch_fleet_demo`` and ``torch_monitored_fleet_demo``: matches,
  replans, deployments, migration chunks (violations, host syncs and the
  printed drifts when monitored) and per-partition matches equal, and
  equal to ``RefEngine``'s;
* ``torch_serve_lm``: with JAX's weights carried in, every request's
  tokens and the batch planner's replans and deployments equal;
* ``torch_train_lm`` and ``torch_adaptive_moe_training``: with JAX's
  weights carried in, every step's loss within
  ``tests/test_torch_train_loop.py``'s bound (1e-5 of max(1, loss)), and
  the expert re-placements at the same steps.

Wall times are printed by the examples and never compared.
"""

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, finish_jax, nest, start_jax
from repro_torch.models.params import load_params

CHUNKS, LM_STEPS, MOE_STEPS = 30, 6, 12
LOSS_TOL = 1e-5
FIELDS = ("full_matches", "pm_created", "replans", "deployments",
          "false_positives")

JAX_CODE = """
import contextlib, dataclasses, io, tempfile
import numpy as np
import jax
from repro import cep
from repro.cep import P, RefEngine, RuntimeConfig
from repro.configs import get_smoke
from repro.core import AdaptiveRunner, EngineConfig, make_policy, seq_pattern
from repro.core.decision import InvariantPolicy
from repro.core.patterns import chain_predicates
from repro.data.cep_streams import StreamConfig, make_stream
from repro.launch import serve as jserve, train as jtrain
from repro.models.model import Model

res = {}
FIELDS = ("full_matches", "pm_created", "replans", "deployments",
          "false_positives")


def metrics(m):
    return np.array([getattr(m, f) for f in FIELDS], dtype=np.int64)


# examples/quickstart.py
pattern = seq_pattern([0, 1, 2, 3], window=4.0,
                      predicates=chain_predicates([0, 1, 2, 3], theta=-0.3))
scfg = StreamConfig(n_types=4, n_chunks=CHUNKS, chunk_cap=512,
                    base_rate=15.0, seed=7)
for name, policy in [("static", make_policy("static")),
                     ("invariant", make_policy("invariant", k=1, d=0.0))]:
    m = AdaptiveRunner(pattern, planner="greedy", policy=policy,
                       engine_cfg=EngineConfig(b_cap=128, m_cap=2048),
                       adaptive_caps=True, measure_regret=True).run(
        make_stream("traffic", scfg))
    res[f"quickstart/{name}"] = metrics(m)
    res[f"quickstart/{name}/regret"] = np.float64(
        m.regret / max(m.regret_samples, 1))


# examples/adaptive_cep_demo.py
def arun(kind, policy):
    cfg = StreamConfig(n_types=4, n_chunks=CHUNKS, chunk_cap=512,
                       base_rate=15.0, seed=3)
    return AdaptiveRunner(pattern, planner="greedy", policy=policy,
                          engine_cfg=EngineConfig(b_cap=128, m_cap=2048),
                          adaptive_caps=True).run(make_stream(kind, cfg))


for kind in ("traffic", "stocks"):
    for pname, kw in [("static", {}), ("unconditional", {}),
                      ("threshold", {"t": 0.4}),
                      ("invariant", {"k": 1, "d": 0.0}),
                      ("invariant", {"k": 1, "d": 0.3})]:
        tag = pname + (f"(d={kw['d']})" if pname == "invariant" else "")
        res[f"adaptive/{kind}/{tag}"] = metrics(
            arun(kind, make_policy(pname, **kw)))
pol = InvariantPolicy(k=1, d_mode="avg")
res["adaptive/traffic/d_avg"] = metrics(arun("traffic", pol))
res["adaptive/d_estimated"] = np.float64(getattr(pol, "d_estimated", 0.0))

# examples/fleet_demo.py and examples/monitored_fleet_demo.py
FP = (P.seq(0, 1, 2).where(P.attr(0) < P.attr(1) - 0.3,
                           P.attr(1) < P.attr(2) - 0.3).within(4.0))
fcfg = StreamConfig(n_types=3, n_chunks=CHUNKS, chunk_cap=256,
                    base_rate=12.0, seed=17)


def tenants():
    return [make_stream("traffic" if p % 2 == 0 else "stocks",
                        dataclasses.replace(fcfg, seed=17 + p))
            for p in range(8)]


for name, mon in (("fleet", False), ("monitored", True)):
    tel = cep.open(FP, partitions=8, plan="order", monitor=mon,
                   config=RuntimeConfig(buffer_capacity=128,
                                        match_capacity=1024,
                                        policy="invariant",
                                        policy_kw={"k": 1, "d": 0.0})
                   ).run(tenants())
    res[f"{name}/counts"] = np.array(
        [tel.chunks, tel.events, tel.matches, tel.replans, tel.deployments,
         tel.migration_partition_chunks, tel.violations, tel.host_syncs],
        dtype=np.int64)
    res[f"{name}/per_partition"] = np.asarray(tel.per_partition_matches,
                                              dtype=np.int64)
    if mon:
        res[f"{name}/last_drift"] = np.asarray(tel.last_drift)
res["oracle"] = np.array([RefEngine(FP.build()).run(s).full_matches
                          for s in tenants()], dtype=np.int64)


# The LM examples: weights, served tokens, per-step losses.
def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


for arch in ("olmo-1b", "deepseek-moe-16b"):
    for k, v in flat(Model(get_smoke(arch)).init(
            jax.random.PRNGKey(0))).items():
        res[f"params/{arch}/{k}"] = v
with contextlib.redirect_stdout(io.StringIO()):
    sched = jserve.main(["--arch", "olmo-1b", "--smoke", "--requests", "16",
                         "--slots", "4", "--cache-len", "256",
                         "--max-new", "12"])
for r in sched.completed:
    res[f"serve/{r.rid}"] = np.asarray(r.out, dtype=np.int64)
res["serve/plan"] = np.array([sched.planner.replans,
                              sched.planner.deployments])

real_jit = jax.jit


def recording(log):
    def jit(fn, *a, **k):
        j = real_jit(fn, *a, **k)

        def call(*args):
            out = j(*args)
            if (isinstance(out, tuple) and len(out) == 3
                    and isinstance(out[2], dict) and "ce" in out[2]):
                log.append(float(out[2]["ce"]))
            return out
        return call
    return jit


for name, argv in (
        ("train", ["--arch", "olmo-1b", "--smoke", "--steps", str(LM_STEPS),
                   "--batch", "8", "--seq", "64", "--lr", "3e-3",
                   "--ckpt-every", "100", "--log-every", "20"]),
        ("moe", ["--arch", "deepseek-moe-16b", "--smoke", "--steps",
                 str(MOE_STEPS), "--batch", "8", "--seq", "64",
                 "--adaptive-placement", "--log-every", "10"])):
    log, buf = [], io.StringIO()
    jax.jit = recording(log)
    try:
        with tempfile.TemporaryDirectory() as d, \\
                contextlib.redirect_stdout(buf):
            jtrain.main(argv + (["--ckpt-dir", d] if name == "train"
                                else []))
    finally:
        jax.jit = real_jit
    res[f"{name}/ce"] = np.array(log)
    res[f"{name}/deployed"] = np.array(
        [int(line.split()[1].rstrip(":")) for line in
         buf.getvalue().splitlines() if "re-placement deployed" in line],
        dtype=np.int64)
np.savez(OUT, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name, argv, **patches):
    """The twin's ``main(argv)`` with ``--device cpu``: (its return, its
    printed lines)."""
    mod = example(name)
    for attr, value in patches.items():
        setattr(mod, attr, value)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv + ["--device", "cpu"])
    return ret, buf.getvalue().splitlines()


def carried(module, params):
    """``module.Model`` whose ``init`` loads the reference's weights."""
    class CarriedModel(module.Model):
        def init(self, generator):
            load_params(self, params)
            return self
    return CarriedModel


def train_losses(argv, want_params):
    """``launch.train``'s per-step losses and printed lines through a twin,
    from the JAX weights."""
    from repro_torch.launch import train

    log = []
    real = train.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def call(*args):
            out = step(*args)
            log.append(float(out[2]["ce"]))
            return out
        return call

    saved = train.Model, train.make_train_step
    train.Model = carried(train, want_params)
    train.make_train_step = recording
    try:
        _, lines = argv()
    finally:
        train.Model, train.make_train_step = saved
    return log, lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    out = str(d / "jax.npz")
    proc = start_jax(f"CHUNKS, LM_STEPS, MOE_STEPS = {CHUNKS}, {LM_STEPS}, "
                     f"{MOE_STEPS}\n" + JAX_CODE, 8, out)
    cut = ["--chunks", str(CHUNKS)]
    try:
        got = {name: run(name, cut) for name in
               ("quickstart", "adaptive_cep_demo", "fleet_demo",
                "monitored_fleet_demo")}
    finally:
        want = finish_jax(proc, out)

    def params(arch):
        p = f"params/{arch}/"
        return nest({k[len(p):]: v for k, v in want.items()
                     if k.startswith(p)})

    from repro_torch.launch import serve
    saved = serve.Model
    serve.Model = carried(serve, params("olmo-1b"))
    try:
        got["serve_lm"] = run("serve_lm", [])
    finally:
        serve.Model = saved
    got["train_lm"] = train_losses(
        lambda: run("train_lm", ["--steps", str(LM_STEPS)],
                    CKPT_DIR=str(d / "ckpt")), params("olmo-1b"))
    got["adaptive_moe_training"] = train_losses(
        lambda: run("adaptive_moe_training", ["--steps", str(MOE_STEPS)]),
        params("deepseek-moe-16b"))
    return got, want


def ints(line):
    return [int(x) for x in re.findall(r"-?\d+", line)]


def test_quickstart_counts_match_jax(runs):
    got, want = runs
    metrics, lines = got["quickstart"]
    for name in ("static", "invariant"):
        m = metrics[name]
        assert [getattr(m, f) for f in FIELDS] == \
            want[f"quickstart/{name}"].tolist(), name
        line = next(ln for ln in lines if ln.startswith(name))
        regret = float(want[f"quickstart/{name}/regret"])
        assert line.endswith(f"plan-regret={regret:.3f}"), line
    assert "invariant" in lines[1]


def test_adaptive_cep_demo_counts_match_jax(runs):
    got, want = runs
    metrics, lines = got["adaptive_cep_demo"]
    assert len(metrics) == 11
    for (kind, tag), m in metrics.items():
        assert [getattr(m, f) for f in FIELDS] == \
            want[f"adaptive/{kind}/{tag}"].tolist(), (kind, tag)
        if tag != "d_avg":
            row = next(ln for ln in lines
                       if ln.split()[:2] == [kind, tag])
            assert ints(row.split(tag)[1])[:5] == \
                want[f"adaptive/{kind}/{tag}"].tolist(), row
    est = float(want["adaptive/d_estimated"])
    assert any(ln.startswith(f"estimated d_avg = {est:.4f}")
               for ln in lines)


@pytest.mark.parametrize("name", ["fleet_demo", "monitored_fleet_demo"])
def test_fleet_demos_match_jax_and_the_oracle(runs, name):
    got, want = runs
    tel, lines = got[name]
    key = "fleet" if name == "fleet_demo" else "monitored"
    counts = want[f"{key}/counts"].tolist()
    assert [tel.chunks, tel.events, tel.matches, tel.replans,
            tel.deployments, tel.migration_partition_chunks,
            tel.violations, tel.host_syncs] == counts
    assert tel.per_partition_matches.tolist() == \
        want[f"{key}/per_partition"].tolist() == want["oracle"].tolist()
    text = "\n".join(lines)
    assert f"matches={counts[2]}  " in text
    assert f"replans={counts[3]}  deployments={counts[4]}" in text
    if key == "fleet":
        assert f"migrating-partition-chunks={counts[5]}" in text
        assert text.rstrip().endswith("fleet == oracle on every partition")
    else:
        assert f"violations={counts[6]}" in text
        assert f"host statistic syncs: {counts[7]} " in text
        drift = [f"{d:+.2f}" for d in want[f"{key}/last_drift"]]
        assert f"last drift per tenant: {drift}" in text
        assert "oracle cross-check: OK" in text


def test_serve_lm_tokens_match_jax(runs):
    got, want = runs
    sched, lines = got["serve_lm"]
    assert len(sched.completed) == 16
    for r in sched.completed:
        assert list(r.out) == want[f"serve/{r.rid}"].tolist(), r.rid
    assert [sched.planner.replans, sched.planner.deployments] == \
        want["serve/plan"].tolist()
    assert lines[-1].startswith("served 16 requests, 192 tokens")


@pytest.mark.parametrize("name,key", [("train_lm", "train"),
                                      ("adaptive_moe_training", "moe")])
def test_training_examples_match_jax(runs, name, key):
    got, want = runs
    losses, lines = got[name]
    ref = want[f"{key}/ce"]
    assert len(losses) == len(ref) > 0
    for s, (a, b) in enumerate(zip(losses, ref)):
        assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b)), (s, a, b)
    deployed = [int(ln.split()[1].rstrip(":")) for ln in lines
                if "re-placement deployed" in ln]
    assert deployed == want[f"{key}/deployed"].tolist()
    assert lines[-1] == "done"
