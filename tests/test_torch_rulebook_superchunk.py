"""The port's superchunked rulebook against the JAX package's, on the CPU.

``config.superchunk = S`` runs S chunks per bucket per window
(``repro_torch.core.scan.RulebookWindow``; eagerly on the CPU, graph
replays on CUDA).  Nothing about the counters or the adaptation
trajectory may depend on S: for S in {2, 3, 8} over the two-phase stream
of ``tests/test_rulebook_superchunk.py`` (rate-skewed phase 2, so flags
fire inside windows), the per-chunk (N, R, K) match counts, the per-rule
counters, violations, replans and deployed plan rows equal the port's
per-chunk stepping and the JAX ``step_superchunk``.  The JAX window
re-runs a window's prefix after an in-window flag and counts that read as
a host sync; the port continues from its carry snapshot, so its
``host_syncs`` is the JAX count less ``in_window_events``.  Further
cases: ``run`` windowing a stream fed in segments, the unmonitored
window, and a hot add between windows.  On a GPU: the captured window
equals the CPU window, also with the plain versions (``backend="ref"``).

The meshed window (``test_superchunk_mesh_d1_matches``) is held in
``tests/test_torch_sharding.py``, the memo's growth case
(``test_growth_under_superchunk_reenters_memo``) in
``tests/test_torch_memo.py``; the re-capture on growth on the card is a
``gpu`` test in ``tests/test_torch_rulebook.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro.core.engine import Chunk as JChunk
from repro_torch.cep import P, RuntimeConfig, open_rulebook
from repro_torch.core import scan
from repro_torch.core.engine import Chunk
from repro_torch.core.fleet import FleetChunk

from test_torch_rulebook import (A, CAP, CFG, K, RULE_FIELDS, make_chunks,
                                 rule_pool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def skewed_chunks(seed, n_chunks, k=K):
    """Two-phase stream: uniform types, then rates skewed to types 3/4 and
    attributes shifted by 0.8, so invariant flags fire inside windows."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n_chunks):
        t0, t1 = float(step), float(step + 1)
        phase2 = step >= n_chunks // 2
        parts = []
        for _ in range(k):
            n = int(rng.integers(5, 10))
            if phase2:
                tid = rng.choice(5, size=n, p=[0.05, 0.05, 0.1, 0.4, 0.4])
            else:
                tid = rng.integers(0, 5, size=n)
            tid = tid.astype(np.int32)
            ts = np.sort(rng.uniform(t0, t1, size=n)).astype(np.float32)
            attr = rng.normal(size=(n, A)).astype(np.float32)
            if phase2:
                attr += 0.8
            pad = CAP - n
            parts.append((np.pad(tid, (0, pad), constant_values=-1),
                          np.pad(ts, (0, pad)),
                          np.pad(attr.astype(np.float32),
                                 ((0, pad), (0, 0))),
                          np.arange(CAP) < n))
        out.append((Chunk(*(np.stack([p[i] for p in parts])
                            for i in range(4))), t0, t1))
    return out


def port_book(rules, monitor=True, device="cpu", **kw):
    return open_rulebook(rules, partitions=K, monitor=monitor,
                         config=RuntimeConfig(device=device, **CFG, **kw))


def per_rule(rb):
    return [(e.matches.tolist(), tuple(getattr(e, f) for f in RULE_FIELDS))
            for e in rb._rules]


@pytest.fixture(scope="module")
def skewed():
    chunks = skewed_chunks(0, 10)
    return ([c for c, _, _ in chunks], [(t0, t1) for _, t0, t1 in chunks])


@pytest.fixture(scope="module")
def per_chunk(skewed):
    """The port's per-chunk run of the skewed stream (4 rules)."""
    cs, edges = skewed
    rb = port_book(rule_pool(P)[:4])
    out = np.stack([rb.step(c, t0, t1) for c, (t0, t1) in zip(cs, edges)])
    return out, rb


@pytest.fixture(scope="module")
def jax_windows(skewed):
    """The JAX ``step_superchunk`` over the skewed stream, per S."""
    cs, edges = skewed
    out = {}
    for s in (2, 3, 8):
        jrb = j_open_rulebook(rule_pool(JP)[:4], partitions=K, monitor=True,
                              config=JConfig(superchunk=s, **CFG))
        got = jrb.step_superchunk(
            [JChunk(*(jnp.asarray(x) for x in c)) for c in cs], edges)
        out[s] = (np.asarray(got), jrb)
    return out


@pytest.mark.parametrize("s", [2, 3, 8])
def test_superchunk_equals_per_chunk_and_jax(s, skewed, per_chunk,
                                             jax_windows):
    """Full windows, a tail window shorter than S and flag-cut windows:
    every count, flag and replan lands where per-chunk stepping (and the
    JAX window) puts it."""
    cs, edges = skewed
    want, rb_pc = per_chunk
    jout, jrb = jax_windows[s]
    scan.reset_counts()
    rb = port_book(rule_pool(P)[:4], superchunk=s)
    out = rb.step_superchunk(cs, edges)
    assert scan.COUNTS["windows"] > 0 and scan.COUNTS["eager_steps"] > 0
    assert rb.telemetry().overflow == 0
    assert rb_pc.telemetry().violations > 0  # flags fire in windows
    assert rb.in_window_events > 0
    assert np.array_equal(out, want)
    assert np.array_equal(out, jout)
    assert per_rule(rb) == per_rule(rb_pc) == per_rule(jrb)
    for e, je in zip(rb._rules, jrb._rules):
        assert np.array_equal(e.bucket.plans_h[:, e.slot],
                              np.asarray(je.bucket.plans_h[:, je.slot]))
    tel, jtel = rb.telemetry(), jrb.telemetry()
    for f in ("chunks", "matches", "replans", "deployments", "violations"):
        assert getattr(tel, f) == getattr(jtel, f) == \
            getattr(rb_pc.telemetry(), f), f
    assert tel.host_syncs == jtel.host_syncs - rb.in_window_events


def test_superchunk_run_segments_match_step():
    """``run`` windows the stream through ``step_superchunk``; segmented
    feeds and an S that does not divide the stream length give the
    per-chunk counters."""
    rules = rule_pool(P)[:3]
    chunks = make_chunks(1, 11)
    fcs = [FleetChunk(chunk=c, t0=t0, t1=t1) for c, _, t0, t1 in chunks]
    rb_pc = port_book(rules)
    for c, _, t0, t1 in chunks:
        rb_pc.step(c, t0, t1)
    rb = port_book(rules, superchunk=4)
    tel_a = rb.run(fcs[:5])
    tel_b = rb.run(fcs[5:])
    assert np.array_equal(rb.match_counts, rb_pc.match_counts)
    assert tel_a.chunks + tel_b.chunks == 11
    assert rb.telemetry().violations == rb_pc.telemetry().violations
    assert per_rule(rb) == per_rule(rb_pc)


def test_superchunk_unmonitored_path():
    """Unmonitored rulebooks window too (no flags: the host surfaces only
    at window boundaries) and equal per-chunk stepping."""
    rules = rule_pool(P)[:4]
    chunks = make_chunks(2, 9)
    cs = [c for c, _, _, _ in chunks]
    edges = [(t0, t1) for _, _, t0, t1 in chunks]
    rb_pc = port_book(rules, monitor=False)
    want = np.stack([rb_pc.step(c, t0, t1) for c, t0, t1
                     in zip(cs, *zip(*edges))])
    rb = port_book(rules, monitor=False, superchunk=4)
    out = rb.step_superchunk(cs, edges)
    assert np.array_equal(out, want)
    assert rb.telemetry().host_syncs == 3 * rb.n_buckets  # 4 + 4 + 1
    assert per_rule(rb) == per_rule(rb_pc)


def test_superchunk_hot_add_remove_between_windows():
    """A hot add and a removal between windows: the windowed book equals
    the per-chunk book through the same script."""
    chunks = skewed_chunks(3, 12)
    cs = [c for c, _, _ in chunks]
    edges = [(t0, t1) for _, t0, t1 in chunks]
    books = [port_book(rule_pool(P)[:4], superchunk=s) for s in (1, 4)]
    outs = []
    for rb in books:
        if rb.config.superchunk > 1:
            parts = [rb.step_superchunk(cs[:4], edges[:4])]
        else:
            parts = [np.stack([rb.step(c, *e) for c, e in
                               zip(cs[:4], edges[:4])])]
        rid = rb.add_rule(rule_pool(P)[6])
        rb.remove_rule(0)
        if rb.config.superchunk > 1:
            parts.append(rb.step_superchunk(cs[4:], edges[4:]))
        else:
            parts.append(np.stack([rb.step(c, *e) for c, e in
                                   zip(cs[4:], edges[4:])]))
        assert rid == 4
        outs.append(np.concatenate([np.pad(parts[0], ((0, 0), (0, 1),
                                                      (0, 0))), parts[1]]))
    assert np.array_equal(outs[0], outs[1])
    assert per_rule(books[0]) == per_rule(books[1])
    assert books[1].telemetry().overflow == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", [None, "ref"])
def test_cuda_window_equals_cpu_window(backend, cuda_device, skewed):
    """The captured rulebook window on the card (kernels, or the plain
    versions with ``backend="ref"``) equals the eager CPU window."""
    cs, edges = skewed
    cpu = port_book(rule_pool(P), superchunk=4)
    want = cpu.step_superchunk(cs, edges)
    scan.reset_counts()
    gpu = port_book(rule_pool(P), device="cuda", superchunk=4,
                    backend=backend)
    got = gpu.step_superchunk(cs, edges)
    assert scan.COUNTS["replays"] > 0 and scan.COUNTS["eager_steps"] == 0
    assert np.array_equal(got, want)
    assert per_rule(gpu) == per_rule(cpu)
    assert gpu.telemetry().host_syncs == cpu.telemetry().host_syncs
