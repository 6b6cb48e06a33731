"""The port's rulebook against the JAX package's, on the CPU.

``repro_torch.cep.open_rulebook`` must equal ``repro.cep.open_rulebook``
exactly at the JAX tests' sizes (``tests/test_rulebook.py``: K = 2, A = 2,
chunk cap 24, ``buffer_capacity=24``, ``match_capacity=512``, its rule
pool): per step the (R, K) full-match counts, and per rule the matches,
partial matches, overflow, Kleene companions, negation vetoes, replans,
deployments and violations, ``host_syncs``, the deployed plan rows and
the sharing ratio, for q in {2, 8} rules in all three ``config.sharing``
modes; through hot add/remove mid-stream.  The same counters equal q solo
port sessions (``Session.step``: the same immediate-deployment semantics)
and the brute-force ``RefEngine``.  Further port-only cases: ``run``
resumed in segments, bucket growth and a new shape, ``reset``, input
validation.  On a GPU, the rulebook on the card equals the CPU one, a hot
add into a free slot makes no CUDA-graph capture, and bucket growth
captures again.

Overflow is asserted zero: match-capacity truncation makes counts
plan-dependent.  The device mesh (``test_mesh_d1_path_matches``) is held
in ``tests/test_torch_sharding.py``, the process-wide memo
(``test_trace_memo_lru_cap``) in ``tests/test_torch_memo.py``.
Superchunk windows: ``tests/test_torch_rulebook_superchunk.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro.core.engine import Chunk as JChunk
from repro.core.greedy import greedy_order_plan as j_greedy_order_plan
from repro.core.stats import uniform_stat as j_uniform_stat
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig, Rulebook, open_rulebook
from repro_torch.core.engine import Chunk
from repro_torch.core.greedy import greedy_order_plan
from repro_torch.core.ref_engine import RefEngine
from repro_torch.core.stats import uniform_stat

A = 2
K = 2
CAP = 24
CFG = dict(buffer_capacity=24, match_capacity=512, estimator_buckets=8)
MODES = ("lattice", "prefix", "none")
RULE_FIELDS = ("pm_created", "overflow", "neg_rejected",
               "closure_expansions", "replans", "deployments", "violations",
               "chunks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small torch ops; with xdist workers on a shared CPU,
    torch's intra-op thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rule_pool(P_):
    """``tests/test_rulebook.py``'s pool in either package's DSL: two
    shared-prefix SEQs, AND, pair, NEG, Kleene, a reversed SEQ, a pair
    AND."""
    return [
        P_.seq(0, 1, 2).where(P_.attr(0, 0) < P_.attr(1, 0) + 0.4)
        .within(2.0).attrs(A),
        P_.seq(0, 1, 4).where(P_.attr(0, 0) < P_.attr(1, 0) + 0.4,
                              P_.attr(1, 1) < P_.attr(2, 0) + 0.3)
        .within(2.0).attrs(A),
        P_.and_(3, 1, 4).where(P_.attr(0, 1) < P_.attr(2, 0) + 0.1)
        .within(2.0).attrs(A),
        P_.seq(2, 4).within(1.5).attrs(A),
        P_.seq(0, P_.neg(3), 1, 2).where(P_.attr(0, 0) < P_.attr(1, 0) + 0.3)
        .within(3.0).attrs(A),
        P_.seq(3, P_.kleene(4, 2), 1).within(2.5).attrs(A),
        P_.seq(4, 2, 0).where(P_.attr(0, 1) < P_.attr(1, 0) + 0.5)
        .within(1.5).attrs(A),
        P_.and_(0, 2).within(1.0).attrs(A),
    ]


def make_chunks(seed, n_chunks, k=K):
    """Stacked numpy chunks + the raw per-partition arrays for the oracle
    (the stream of ``tests/test_rulebook.py::make_chunks``)."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n_chunks):
        t0, t1 = float(step), float(step + 1)
        parts, raw = [], []
        for _ in range(k):
            n = int(rng.integers(4, 10))
            tid = rng.integers(0, 5, size=n).astype(np.int32)
            ts = np.sort(rng.uniform(t0, t1, size=n)).astype(np.float32)
            attr = rng.normal(size=(n, A)).astype(np.float32)
            raw.append((tid, ts, attr))
            pad = CAP - n
            parts.append((np.pad(tid, (0, pad), constant_values=-1),
                          np.pad(ts, (0, pad)),
                          np.pad(attr, ((0, pad), (0, 0))),
                          np.arange(CAP) < n))
        chunk = Chunk(*(np.stack([p[i] for p in parts]) for i in range(4)))
        out.append((chunk, raw, t0, t1))
    return out


def jchunk(chunk):
    return JChunk(*(jnp.asarray(x) for x in chunk))


def port_cfg(**kw):
    return RuntimeConfig(device="cpu", **CFG, **kw)


def rule_counters(rb):
    """Per rule: (matches (K,), every counter of ``RULE_FIELDS``) — the
    rule entries of either package."""
    return [(e.matches.tolist(), tuple(getattr(e, f) for f in RULE_FIELDS))
            for e in rb._rules]


def assert_books_equal(rb, jrb):
    """Every per-rule counter, the aggregate telemetry (``host_syncs``
    included), the deployed plan rows and the sharing structure."""
    assert rule_counters(rb) == rule_counters(jrb)
    assert np.array_equal(rb.match_counts, jrb.match_counts)
    tel, jtel = rb.telemetry(), jrb.telemetry()
    for f in ("chunks", "matches", "overflow", "neg_rejected",
              "closure_expansions", "replans", "deployments", "violations",
              "host_syncs"):
        assert getattr(tel, f) == getattr(jtel, f), f
    for e, je in zip(rb._rules, jrb._rules):
        assert np.array_equal(e.bucket.plans_h[:, e.slot],
                              np.asarray(je.bucket.plans_h[:, je.slot]))
        assert (e.slot, e.chain, e.pinned, e.active) == \
            (je.slot, je.chain, je.pinned, je.active)
    assert rb.sharing_ratio() == jrb.sharing_ratio()
    assert rb.n_buckets == jrb.n_buckets
    assert rb.rules == jrb.rules


@pytest.fixture(scope="module")
def stream8():
    return make_chunks(0, 8)


@pytest.fixture(scope="module")
def jax_books(stream8):
    """The JAX rulebook over the 8-chunk stream, per (q, sharing mode):
    its per-step outputs and the book (one baseline for the module)."""
    out = {}
    for q in (2, 8):
        for mode in MODES:
            jrb = j_open_rulebook(rule_pool(JP)[:q], partitions=K,
                                  monitor=True,
                                  config=JConfig(sharing=mode, **CFG))
            steps = np.stack([np.asarray(jrb.step(jchunk(c), t0, t1))
                              for c, _, t0, t1 in stream8])
            out[q, mode] = (steps, jrb)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [2, 8])
def test_rulebook_equals_jax(q, mode, stream8, jax_books):
    """Per step and per rule, the port equals the JAX rulebook exactly:
    counters, replans, ``host_syncs``, deployed plan rows, lattice."""
    want_steps, jrb = jax_books[q, mode]
    rb = open_rulebook(rule_pool(P)[:q], partitions=K, monitor=True,
                       config=port_cfg(sharing=mode))
    steps = np.stack([rb.step(c, t0, t1) for c, _, t0, t1 in stream8])
    assert np.array_equal(steps, want_steps)
    assert rb.telemetry().overflow == 0
    assert_books_equal(rb, jrb)
    if q >= 2 and mode == "lattice":
        # rules 0 and 1 share their (0, 1) opening join
        assert rb.sharing_ratio() > 1.0
    if q == 8:
        assert rb.telemetry().violations > 0  # replans are exercised
        assert rb.telemetry().neg_rejected > 0
        assert rb.telemetry().closure_expansions > 0


@pytest.mark.parametrize("q", [2, 8])
def test_rulebook_equals_sessions_and_oracle(q, stream8):
    """Per-rule counters equal q solo port sessions driven by ``step`` and
    the brute-force oracle, per partition."""
    rules = rule_pool(P)[:q]
    rb = open_rulebook(rules, partitions=K, monitor=True, config=port_cfg())
    sessions = [cep.open(r, partitions=K, plan="order", monitor=True,
                         config=port_cfg()) for r in rules]
    refs = [[RefEngine(r.build()) for _ in range(K)] for r in rules]
    sess_counts = np.zeros((q, K), np.int64)
    ref_counts = np.zeros((q, K), np.int64)
    neg = np.zeros(q, np.int64)
    for chunk, raw, t0, t1 in stream8:
        rb.step(chunk, t0, t1)
        for i, s in enumerate(sessions):
            sess_counts[i] += np.asarray(s.step(chunk, t0, t1))
        for i in range(q):
            for k, (tid, ts, attr) in enumerate(raw):
                r = refs[i][k].process_chunk(tid, ts, attr, t0, t1)
                ref_counts[i, k] += r.full_matches
                neg[i] += r.neg_rejected
    assert rb.telemetry().overflow == 0
    assert all(s.telemetry().overflow == 0 for s in sessions)
    assert np.array_equal(rb.match_counts, sess_counts)
    assert np.array_equal(rb.match_counts, ref_counts)
    assert [rb.telemetry(i).neg_rejected for i in range(q)] == neg.tolist()


def hot_add_remove(open_fn, P_, step_fn, chunks):
    """The hot add/remove script of ``tests/test_rulebook.py``: 6 rules,
    a hot add into the spare slot after 5 chunks, the removal of a shared
    class member and of the class's representative after 9."""
    rb = open_fn(rule_pool(P_)[:6], spare_slots=1)
    outs = [step_fn(rb, c) for c in chunks[:5]]
    rid = rb.add_rule(rule_pool(P_)[6])
    outs += [step_fn(rb, c) for c in chunks[5:9]]
    rb.remove_rule(1)
    rb.remove_rule(0)
    outs += [step_fn(rb, c) for c in chunks[9:]]
    # (R, K) per step; the 6 steps before the hot add padded to R = 7.
    return rb, rid, np.stack([np.pad(o, ((0, 7 - len(o)), (0, 0)))
                              for o in outs])


def test_hot_add_remove_midstream_equals_jax():
    """Hot add into a free slot and hot removal of a shared class's
    representative: every counter equals the JAX rulebook's through the
    same script, removed rows go silent, the added rule equals its solo
    session, and nothing is captured (the per-chunk step runs eagerly)."""
    chunks = make_chunks(1, 12)
    rb, rid, steps = hot_add_remove(
        lambda rules, **kw: open_rulebook(rules, partitions=K, monitor=True,
                                          config=port_cfg(), **kw),
        P, lambda b, c: b.step(c[0], c[2], c[3]), chunks)
    jrb, jrid, jsteps = hot_add_remove(
        lambda rules, **kw: j_open_rulebook(
            rules, partitions=K, monitor=True, config=JConfig(**CFG), **kw),
        JP, lambda b, c: np.asarray(b.step(jchunk(c[0]), c[2], c[3])),
        chunks)
    assert rid == jrid == 6
    assert np.array_equal(steps, jsteps)
    assert_books_equal(rb, jrb)
    assert rb.telemetry().overflow == 0
    assert steps[9:, 0].sum() == 0 and steps[9:, 1].sum() == 0
    assert 0 not in rb.rules and 1 not in rb.rules
    assert rb.trace_count() == 0
    solo = cep.open(rule_pool(P)[6], partitions=K, plan="order",
                    monitor=True, config=port_cfg())
    want = sum(np.asarray(solo.step(c, t0, t1))
               for c, _, t0, t1 in chunks[5:])
    assert rb.match_counts[rid].tolist() == want.tolist()


def test_growth_and_new_shape_equal_solo_sessions():
    """Adding into a full bucket (capacity doubles) and adding a rule of a
    shape the rulebook has never seen (a new bucket): the new rules equal
    their solo sessions, the old ones are undisturbed."""
    chunks = make_chunks(2, 8)
    pool = rule_pool(P)
    first = [pool[3], pool[7]]                    # one full n = 2 bucket
    grown = P.seq(1, 3).within(1.0).attrs(A)
    new_shape = pool[5]                           # n = 3 with Kleene
    rb = open_rulebook(first, partitions=K, monitor=True, config=port_cfg())

    def solo(r):
        return cep.open(r, partitions=K, plan="order", monitor=True,
                        config=port_cfg())

    solos = [solo(r) for r in first]
    want = np.zeros((4, K), np.int64)
    for i, (c, _, t0, t1) in enumerate(chunks):
        if i == 3:  # added rules start with empty rings, as a new session
            assert rb.add_rule(grown) == 2
            assert rb.add_rule(new_shape) == 3
            solos += [solo(grown), solo(new_shape)]
        rb.step(c, t0, t1)
        for j, s in enumerate(solos):
            want[j] += np.asarray(s.step(c, t0, t1))
    assert rb.n_buckets == 2
    assert rb._rules[0].bucket.q_cap == 4
    assert rb.telemetry().overflow == 0
    assert np.array_equal(rb.match_counts, want)


def test_run_resume_segments():
    """``run`` over a stream equals ``run`` over two segments of it, and
    the per-chunk ``step`` loop."""
    from repro_torch.core.fleet import FleetChunk

    rules = rule_pool(P)[:3]
    chunks = make_chunks(3, 10)
    fcs = [FleetChunk(chunk=c, t0=t0, t1=t1) for c, _, t0, t1 in chunks]
    one = open_rulebook(rules, partitions=K, monitor=True, config=port_cfg())
    tel = one.run(fcs)
    two = open_rulebook(rules, partitions=K, monitor=True, config=port_cfg())
    tel_a = two.run(fcs[:5])
    tel_b = two.run(fcs[5:])
    step = open_rulebook(rules, partitions=K, monitor=True, config=port_cfg())
    for c, _, t0, t1 in chunks:
        step.step(c, t0, t1)
    assert np.array_equal(one.match_counts, two.match_counts)
    assert np.array_equal(one.match_counts, step.match_counts)
    assert tel.matches == tel_a.matches + tel_b.matches
    assert tel.chunks == tel_a.chunks + tel_b.chunks == 10
    assert tel.per_partition_matches.tolist() == (
        tel_a.per_partition_matches + tel_b.per_partition_matches).tolist()
    assert tel.replans == tel_a.replans + tel_b.replans


def test_reset_keeps_rules_and_clears_state():
    """After ``reset`` the book runs a stream exactly as a fresh book with
    the same deployed plans would: counters restart, rules stay."""
    rules = rule_pool(P)[:2]
    chunks = make_chunks(4, 4)
    rb = open_rulebook(rules, partitions=K, monitor=False, config=port_cfg())
    first = [rb.step(c, t0, t1) for c, _, t0, t1 in chunks]
    rb.reset()
    assert rb.telemetry().matches == 0 and rb.telemetry().chunks == 0
    again = [rb.step(c, t0, t1) for c, _, t0, t1 in chunks]
    assert np.array_equal(np.stack(first), np.stack(again))
    assert rb.rules == (0, 1)


def test_rulebook_input_validation():
    """The reference's validation, message for message."""
    with pytest.raises(ValueError, match="OR"):
        open_rulebook([P.or_(P.seq(0, 1).within(2.0),
                             P.seq(1, 2).within(2.0))],
                      config=RuntimeConfig(device="cpu"))
    with pytest.raises(ValueError, match="sharing"):
        RuntimeConfig(sharing="bogus")
    with pytest.raises(ValueError, match="partitions"):
        open_rulebook([P.seq(0, 1).within(2.0)], partitions=0,
                      config=RuntimeConfig(device="cpu"))
    with pytest.raises(ValueError, match="invariant"):
        open_rulebook([P.seq(0, 1).within(2.0)], monitor=True,
                      config=RuntimeConfig(policy="threshold", device="cpu"))
    with pytest.raises(ValueError, match="at least one rule"):
        open_rulebook([], config=RuntimeConfig(device="cpu"))
    rb = open_rulebook([P.seq(0, 1).within(2.0).attrs(A)], partitions=K,
                       monitor=False, config=port_cfg())
    assert isinstance(rb, Rulebook)
    chunk, _, t0, t1 = make_chunks(5, 1)[0]
    with pytest.raises(ValueError, match="attribute"):
        rb.step(chunk._replace(attr=chunk.attr[..., :1]), t0, t1)
    with pytest.raises(ValueError, match="stack"):
        rb.step(Chunk(*(x[0] for x in chunk)), t0, t1)
    with pytest.raises(KeyError):
        rb.remove_rule(7)
    rb.remove_rule(0)
    with pytest.raises(ValueError, match="already removed"):
        rb.remove_rule(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            open_rulebook([P.seq(0, 1).within(2.0)])  # device="cuda"


def test_greedy_pin_prefix_matches_jax():
    """``greedy_order_plan(pin=...)`` (the lattice's pinned prefixes)
    equals the JAX planner's plans and deciding-condition blocks."""
    for i in range(8):
        pat, jpat = rule_pool(P)[i].build(), rule_pool(JP)[i].build()
        free, _ = greedy_order_plan(pat, uniform_stat(pat.n))
        for depth in range(1, pat.n + 1):
            pin = tuple(int(o) for o in free.order[:depth])
            plan, dcs = greedy_order_plan(pat, uniform_stat(pat.n), pin=pin)
            jplan, jdcs = j_greedy_order_plan(jpat, j_uniform_stat(jpat.n),
                                              pin=pin)
            assert tuple(plan.order) == tuple(jplan.order)
            assert [(name, len(rows)) for name, rows in dcs] == \
                [(name, len(rows)) for name, rows in jdcs]
            assert all(not rows for _, rows in dcs[:depth])


def test_flowsense_tenant_rules_share_nothing():
    """The FlowSense tenant's three rules (alert, ack, combo; copied from
    ``repro.data.scenarios.flowsense``) are structurally disjoint: every
    sharing mode reports 1.0, and fusion makes two buckets."""
    rules = [
        P.seq(0, P.neg(3), 1, 2).where(P.attr(0) < P.attr(1) + 0.3,
                                       P.attr(1) < P.attr(2) + 0.3)
        .within(3.0),
        P.seq(0, 3).within(3.0),
        P.and_(1, 2).where(P.attr(0) < P.attr(1) + 0.3).within(2.0),
    ]
    for mode in MODES:
        rb = open_rulebook(rules, partitions=2, monitor=False,
                           config=RuntimeConfig(device="cpu", sharing=mode))
        assert rb.sharing_ratio() == 1.0
        assert rb.n_buckets == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_rulebook_equals_cpu(cuda_device, stream8):
    """The rulebook on the card (the kernels) equals the CPU run (the
    plain versions), every per-rule counter."""
    books = [open_rulebook(rule_pool(P), partitions=K, monitor=True,
                           config=RuntimeConfig(device=d, **CFG))
             for d in ("cpu", "cuda")]
    for rb in books:
        for c, _, t0, t1 in stream8:
            rb.step(c, t0, t1)
    assert rule_counters(books[0]) == rule_counters(books[1])
    cpu, gpu = ([e.bucket.plans_h[:, e.slot].tolist() for e in rb._rules]
                for rb in books)
    assert gpu == cpu


@pytest.mark.gpu
def test_cuda_hot_add_captures_nothing_growth_recaptures(cuda_device):
    """Superchunk windows on the card: a hot add into a free slot is row
    writes (no kernel build, no CUDA-graph capture); adding into a full
    bucket grows it and its next window captures once more."""
    from repro_torch.core import fleet, scan
    from repro_torch.kernels import window_join

    fleet.clear_trace_memo()  # count this book's captures from none
    chunks = make_chunks(6, 12)
    cs = [c for c, _, _, _ in chunks]
    edges = [(t0, t1) for _, _, t0, t1 in chunks]
    rb = open_rulebook(rule_pool(P)[:4], partitions=K, monitor=True,
                       config=RuntimeConfig(device="cuda", superchunk=4,
                                            **CFG), spare_slots=1)
    rb.step_superchunk(cs[:4], edges[:4])
    lib = window_join.library_path()
    pre = (rb.trace_count(), scan.COUNTS["captures"])
    assert pre[0] == rb.n_buckets
    rid = rb.add_rule(rule_pool(P)[6])            # into the spare slot
    rb.step_superchunk(cs[4:8], edges[4:8])
    assert (rb.trace_count(), scan.COUNTS["captures"]) == pre
    assert window_join.library_path() == lib and window_join._lib is not None
    bucket = rb._rules[rid].bucket
    while bucket.free_slots:                      # fill the bucket up
        rb.add_rule(rule_pool(P)[6])
    rb.add_rule(rule_pool(P)[6])                  # full -> grows
    rb.step_superchunk(cs[8:], edges[8:])
    assert rb.trace_count() == pre[0] + 1
    assert scan.COUNTS["captures"] == pre[1] + 1
    assert rb.telemetry().overflow == 0
