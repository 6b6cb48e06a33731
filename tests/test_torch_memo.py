"""The port's process-wide memo of steps and windows, against the JAX
package's trace memo, on the CPU.

``repro_torch.core.fleet._shared_trace`` keeps, per equal config, one
fleet step, one monitored step and one superchunk window
(``FleetEngine``), one rulebook plane (``multipattern.make_rulebook_plane``)
and one rulebook window (``scan.make_rulebook_scan``), in an LRU of
``_TRACE_MEMO_CAP`` entries, under the reference's keys (capacity left
out of the rulebook's).  Ported from the reference:
``test_trace_memo_lru_cap`` (``tests/test_rulebook.py``) and
``test_growth_under_superchunk_reenters_memo``
(``tests/test_rulebook_superchunk.py``: growth enters a new shape of the
same window, one trace, no new entry), each held to the JAX package's
sizes, deltas and counters.  New here: which configs share an entry
(equal to the JAX package's for k, laplace and the window; "cuda" and
"cuda:0", a None backend and the one it resolves to, are one key), two
sessions' windows driven in turns (A, B, A, B) equal their solo runs
(they share the window's static tensors), a session opened before
``clear_trace_memo()`` equals its twin after it, and a meshed engine
never enters the memo.  On a GPU: a second equal-config session captures
no graph and equals the first, and the interleaved windows hold.
"""

import warnings

import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro.core import fleet as jfleet
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.multipattern import BucketSpec as JBucketSpec
from repro.core.multipattern import make_rulebook_plane as j_make_plane
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig, open_rulebook
from repro_torch.core import fleet, scan
from repro_torch.core.engine import EngineConfig
from repro_torch.core.multipattern import BucketSpec, make_rulebook_plane

from test_torch_rulebook import (A, CFG, K, jchunk, make_chunks, rule_counters,
                                 rule_pool)
from test_torch_superchunk import CONFIG, jstreams, rule, streams

INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "neg_rejected",
              "closure_expansions", "escalations",
              "migration_partition_chunks")
SEEDS = (31, 57)  # sessions A and B: two different K=2 streams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _memos_as_found():
    """Both packages' memos start empty here and are left as found: the
    JAX memo shares traces across this process's tests, and a trace this
    module leaves behind would hide a retrace that another module's test
    counts."""
    saved = [(m, list(m.items())) for m in (jfleet._TRACE_MEMO,
                                            fleet._TRACE_MEMO)]
    for m, _ in saved:
        m.clear()
    yield
    for m, items in saved:
        m.clear()
        m.update(items)


def growth_run(open_book, P_, chunk_of, memo):
    """The reference's growth case on either package: a full n=2 bucket
    stepped in windows of 4, grown by a hot add, stepped on.  Returns the
    trace-count and memo-size deltas of the growth, the book and its
    per-chunk counts."""
    rb = open_book([rule_pool(P_)[3], rule_pool(P_)[7]])
    chunks = make_chunks(0, 12)
    cs = [chunk_of(c) for c, _, _, _ in chunks]
    edges = [(t0, t1) for _, _, t0, t1 in chunks]
    outs = [np.asarray(rb.step_superchunk(cs[:4], edges[:4]))]
    pre = (rb.trace_count(), len(memo))
    rb.add_rule(P_.seq(1, 3).within(1.0).attrs(A))  # full bucket -> grow
    outs.append(np.asarray(rb.step_superchunk(cs[4:8], edges[4:8])))
    grown = (rb.trace_count() - pre[0], len(memo) - pre[1])
    outs.append(np.asarray(rb.step_superchunk(cs[8:], edges[8:])))
    warm = rb.trace_count() - pre[0]
    return grown, warm, rb, outs


GROWTH_CFG = dict(superchunk=4, buffer_capacity=20, match_capacity=512,
                  estimator_buckets=8)


@pytest.fixture(scope="module")
def jax_baseline():
    """The JAX package's runs, once per module: the growth case, and
    sessions A and B through the serving plane's ``step`` loop."""
    out = {"growth": growth_run(
        lambda rules: j_open_rulebook(rules, partitions=K, monitor=True,
                                      config=JConfig(**GROWTH_CFG)),
        JP, jchunk, jfleet._TRACE_MEMO)}
    for seed in SEEDS:
        sess = jcep.open(rule(JP), partitions=2, plan="order", monitor=True,
                         config=JConfig(**CONFIG))
        out[seed] = np.stack([np.asarray(sess.step(fc.chunk, fc.t0, fc.t1))
                              for fc in jstreams(2, seed=seed)])
    return out


def test_trace_memo_lru_cap():
    """Churning configs never grow the memo past its cap, as in the
    JAX package; a hit inserts nothing."""
    for memo, clear, make, spec, cfg in (
            (fleet._TRACE_MEMO, fleet.clear_trace_memo, make_rulebook_plane,
             BucketSpec, EngineConfig(device="cpu")),
            (jfleet._TRACE_MEMO, jfleet.clear_trace_memo, j_make_plane,
             JBucketSpec, JEngineConfig())):
        clear()
        assert len(memo) == 0
        bspec = spec(n=2, has_neg=False, has_kleene=False, n_attrs=1)
        for i in range(fleet._TRACE_MEMO_CAP + 24):
            make(bspec, cfg, 1, False, laplace=2.0 + i)
            assert len(memo) <= fleet._TRACE_MEMO_CAP
        assert len(memo) == fleet._TRACE_MEMO_CAP == jfleet._TRACE_MEMO_CAP
        size = len(memo)
        make(bspec, cfg, 1, False, laplace=2.0 + fleet._TRACE_MEMO_CAP + 23)
        assert len(memo) == size
        clear()
        assert len(memo) == 0


def test_growth_under_superchunk_reenters_memo(jax_baseline):
    """Bucket growth while windowing: the grown Qb enters a new shape of
    the SAME memoized window — exactly one trace (on the card, one
    capture), zero new memo entries — as in the JAX package, with equal
    counters."""
    grown, warm, rb, outs = growth_run(
        lambda rules: open_rulebook(
            rules, partitions=K, monitor=True,
            config=RuntimeConfig(device="cpu", **GROWTH_CFG)),
        P, lambda c: c, fleet._TRACE_MEMO)
    j_grown, j_warm, jrb, j_outs = jax_baseline["growth"]
    assert grown == j_grown == (1, 0)
    assert warm == j_warm == 1
    for got, want in zip(outs, j_outs):
        assert np.array_equal(got, want)
    assert rule_counters(rb) == rule_counters(jrb)
    assert np.array_equal(rb.match_counts, np.asarray(jrb.match_counts))
    assert rb.telemetry().overflow == 0


def test_equal_configs_share_one_memo_entry():
    """Equal configs share their steps and window (``is``), as in the JAX
    package; another k or laplace does not.  "cuda" and "cuda:0" are one
    key, and so are a None backend and the one it resolves to."""
    pat, jpat = rule(P).build(), rule(JP).build()
    cfg = EngineConfig(b_cap=64, m_cap=1024, device="cpu")
    jcfg = JEngineConfig(b_cap=64, m_cap=1024)

    def shared(mk, cfg_, **kw):
        a = mk("order", pat if mk is fleet.FleetEngine else jpat, 4, cfg_)
        b = mk("order", pat if mk is fleet.FleetEngine else jpat,
               kw.get("k", 4), cfg_,
               monitor_laplace=kw.get("laplace", 1.0))
        return (a._process is b._process,
                a.superchunk_scan(True) is b.superchunk_scan(True))

    for kw, want in (({}, True), ({"k": 2}, False),
                     ({"laplace": 2.0}, False)):
        assert shared(fleet.FleetEngine, cfg, **kw) == (want, want)
        assert shared(jfleet.FleetEngine, jcfg, **kw) == (want, want)
    a = fleet.FleetEngine("order", pat, 4, cfg)
    b = fleet.FleetEngine("order", pat, 4, EngineConfig(
        b_cap=64, m_cap=1024, device="cpu", backend="ref"))
    assert a.superchunk_scan(True) is b.superchunk_scan(True)
    key = fleet._memo_config
    assert key(EngineConfig(device="cuda")) == \
        key(EngineConfig(device="cuda:0", backend="cuda"))
    assert key(EngineConfig(device="cuda")) != key(EngineConfig(device="cpu"))
    assert key(EngineConfig(device="cpu")) == \
        key(EngineConfig(device="cpu", backend="ref"))
    # Rulebooks: the per-chunk planes and the windows.
    books = [open_rulebook(rule_pool(P)[:2], partitions=K, monitor=True,
                           config=RuntimeConfig(device="cpu", superchunk=4,
                                                laplace=lp, **CFG))
             for lp in (1.0, 1.0, 2.0)]
    chunks = make_chunks(0, 4)
    for rb in books:
        rb.step_superchunk([c for c, _, _, _ in chunks],
                           [(t0, t1) for _, _, t0, t1 in chunks])
    (b0, b1, b2) = (rb._buckets[0] for rb in books)
    assert b0.plane is b1.plane and b0.scan_plane is b1.scan_plane
    assert b0.plane is not b2.plane and b0.scan_plane is not b2.scan_plane
    assert books[1].trace_count() == books[0].trace_count() == 1


def open_session(device="cpu"):
    return cep.open(rule(P), partitions=2, plan="order", monitor=True,
                    config=RuntimeConfig(device=device, superchunk=4,
                                         **CONFIG))


def drive(sess, recs, path, lo, hi):
    """One window (chunks ``lo`` to ``hi``) of a session: the serving
    plane's per-chunk matches, or the batch plane's run telemetry."""
    seg = recs[lo:hi]
    if path == "serving":
        return sess.step_superchunk([fc.chunk for fc in seg],
                                    [(fc.t0, fc.t1) for fc in seg]).tolist()
    tel = sess.run(seg, resume=lo > 0)
    return ([getattr(tel, f) for f in INT_FIELDS],
            tel.per_partition_matches.tolist())


def window_of(sess, path):
    front = sess._serving if path == "serving" else sess._runner
    return front.fleet.superchunk_scan(True)


def interleave(path, device="cpu"):
    """Sessions A and B solo, then A and B again with their windows in
    turns; returns (solo, interleaved) per-window results and the
    interleaved pair."""
    recs = [list(streams(2, seed=s)) for s in SEEDS]
    solo = []
    for r in recs:
        sess = open_session(device)
        solo.append([drive(sess, r, path, i, i + 4) for i in (0, 4, 8)])
    pair = [open_session(device), open_session(device)]
    turns = [[], []]
    for i in (0, 4, 8):
        for j in (0, 1):
            turns[j].append(drive(pair[j], recs[j], path, i, i + 4))
    return solo, turns, pair


@pytest.mark.parametrize("path", ["serving", "run"])
def test_interleaved_windows_equal_solo_runs(path, jax_baseline):
    """Two equal-config sessions share one window and its static tensors;
    driven window by window in turns (A, B, A, B), each equals its solo
    run, and the serving plane's per-chunk matches equal the JAX
    package's ``step`` loop."""
    fleet.clear_trace_memo()
    solo, turns, pair = interleave(path)
    assert window_of(pair[0], path) is window_of(pair[1], path)
    assert turns == solo
    assert solo[0] != solo[1]
    if path == "serving":
        for runs, seed in zip(solo, SEEDS):
            assert np.concatenate(runs).tolist() == \
                jax_baseline[seed].tolist()


def test_cleared_memo_keeps_open_sessions():
    """``clear_trace_memo()`` between two windows of an open session: it
    keeps its window and equals its uncleared twin; a session opened
    after the clear builds a new window."""
    recs = list(streams(2, seed=SEEDS[0]))
    twin = open_session()
    want = [drive(twin, recs, "serving", i, i + 4) for i in (0, 4, 8)]
    sess = open_session()
    got = [drive(sess, recs, "serving", 0, 4)]
    window = window_of(sess, "serving")
    fleet.clear_trace_memo()
    assert len(fleet._TRACE_MEMO) == 0
    got += [drive(sess, recs, "serving", i, i + 4) for i in (4, 8)]
    assert got == want
    assert window_of(sess, "serving") is window
    late = open_session()
    drive(late, recs, "serving", 0, 4)
    assert window_of(late, "serving") is not window


def test_meshed_engine_never_enters_memo():
    """A meshed engine (and a meshed rulebook) builds its own steps and
    windows and leaves the memo as it was, as in the JAX package."""
    fleet.clear_trace_memo()
    engines = [fleet.FleetEngine("order", rule(P).build(), 4,
                                 EngineConfig(device="cpu"), mesh=1)
               for _ in range(2)]
    wins = [e.superchunk_scan(True) for e in engines]
    assert wins[0] is not wins[1]
    assert engines[0]._trace_key("plain") is None
    rb = open_rulebook(rule_pool(P)[:2], partitions=K, monitor=True,
                       config=RuntimeConfig(device="cpu", superchunk=4,
                                            mesh=1, **CFG))
    chunks = make_chunks(0, 4)
    rb.step_superchunk([c for c, _, _, _ in chunks],
                       [(t0, t1) for _, _, t0, t1 in chunks])
    assert len(fleet._TRACE_MEMO) == 0
    assert rb.trace_count() == 1
    size = len(jfleet._TRACE_MEMO)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jfleet.FleetEngine("order", rule(JP).build(), 4, JEngineConfig(),
                           mesh=1).superchunk_scan(True)
    assert len(jfleet._TRACE_MEMO) == size


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["serving", "run"])
def test_cuda_second_session_captures_nothing(path, cuda_device):
    """On the card a second equal-config session replays the first one's
    graphs: it captures none and equals the first."""
    fleet.clear_trace_memo()
    recs = list(streams(2, seed=SEEDS[0]))
    scan.reset_counts()
    first = open_session("cuda")
    want = [drive(first, recs, path, i, i + 4) for i in (0, 4, 8)]
    assert scan.COUNTS["captures"] > 0
    scan.reset_counts()
    second = open_session("cuda")
    got = [drive(second, recs, path, i, i + 4) for i in (0, 4, 8)]
    assert scan.COUNTS["captures"] == 0 and scan.COUNTS["replays"] > 0
    assert scan.COUNTS["eager_steps"] == 0
    assert got == want
    cpu = open_session()
    assert [drive(cpu, recs, path, i, i + 4) for i in (0, 4, 8)] == want


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["serving", "run"])
def test_cuda_interleaved_windows_equal_solo_runs(path, cuda_device):
    """The interleaved A/B windows on the card: the shared graphs write
    their outputs into one pool, copied out after each replay."""
    fleet.clear_trace_memo()
    solo, turns, pair = interleave(path, "cuda")
    assert window_of(pair[0], path) is window_of(pair[1], path)
    assert turns == solo
    assert solo[0] != solo[1]
    assert interleave(path)[0] == solo
