"""The port's sub-join sharing lattice against the JAX package's.

The twins of ``tests/test_rulebook_sharing.py``'s
``test_deep_pair_lattice_beats_prefix_structurally`` and
``test_sharing_survives_hot_add_remove`` (its modes test and its FlowSense
test have twins in ``tests/test_torch_rulebook.py``), at the reference's
sizes (K = 2, A = 2, chunk cap 24, ``buffer_capacity=24``,
``match_capacity=512``, 8 estimator buckets).  Both packages' rulebooks
must agree on the sharing ratio, the chains and the plan rows, and,
through the hot add of pool rule 6 and the removal of rule 0 (the shared
class's representative), on every (R, K) step output and every per-rule
counter; the reference's assertions must hold on the port.
"""

import numpy as np
import pytest
import torch

from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro_torch.cep import P, open_rulebook
from test_torch_rulebook import (A, CFG, K, assert_books_equal, jchunk,
                                 make_chunks, port_cfg, rule_pool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def books(rules, jrules, mode, **kw):
    """The same rulebook in each package: (port, JAX)."""
    return (open_rulebook(rules, partitions=K, config=port_cfg(sharing=mode),
                          **kw),
            j_open_rulebook(jrules, partitions=K,
                            config=JConfig(sharing=mode, **CFG), **kw))


def deep_pair(P_):
    return [
        P_.seq(0, 1, 2, 3).where(P_.attr(0, 0) < P_.attr(1, 0) + 0.4)
        .within(3.0).attrs(A),
        P_.seq(0, 1, 2, 4).where(P_.attr(0, 0) < P_.attr(1, 0) + 0.4)
        .within(3.0).attrs(A),
    ]


def test_deep_pair_lattice_beats_prefix_structurally():
    """Two 4-arity rules sharing positions 0-1-2 diverge only at the last
    join: the lattice shares two depths (6/4 = 1.5), prefix-only one (6/5
    = 1.2), in both packages."""
    ratios = {}
    for mode in ("lattice", "prefix"):
        rb, jrb = books(deep_pair(P), deep_pair(JP), mode, monitor=False)
        assert_books_equal(rb, jrb)
        ratios[mode] = rb.sharing_ratio()
    assert ratios["lattice"] > ratios["prefix"] > 1.0
    assert (ratios["lattice"], ratios["prefix"]) == (1.5, 1.2)


def test_sharing_survives_hot_add_remove():
    """Hot-added rules start singleton chains; removing a shared class's
    representative reroutes the class without disturbing counters."""
    chunks = make_chunks(0, 6)          # the reference's ``rng`` fixture
    opened = {m: books(rule_pool(P)[:4], rule_pool(JP)[:4], m, monitor=True,
                       spare_slots=1) for m in ("lattice", "none")}
    (rb, jrb), (solo, jsolo) = opened["lattice"], opened["none"]

    def step_all(part):
        for chunk, _, t0, t1 in part:
            jc = jchunk(chunk)
            for book, jbook in ((rb, jrb), (solo, jsolo)):
                got = book.step(chunk, t0, t1)
                assert np.array_equal(got, np.asarray(jbook.step(jc, t0,
                                                                 t1)))

    step_all(chunks[:3])
    before = rb.sharing_ratio()
    assert before == jrb.sharing_ratio()
    for book, jbook in ((rb, jrb), (solo, jsolo)):
        assert book.add_rule(rule_pool(P)[6]) == jbook.add_rule(
            rule_pool(JP)[6])
        book.remove_rule(0)    # representative of the shared (0, 1) class
        jbook.remove_rule(0)
        assert_books_equal(book, jbook)
    assert rb.sharing_ratio() <= before
    step_all(chunks[3:])
    for book, jbook in ((rb, jrb), (solo, jsolo)):
        assert_books_equal(book, jbook)
    assert rb.telemetry().overflow == 0
    assert np.array_equal(rb.match_counts, solo.match_counts)
