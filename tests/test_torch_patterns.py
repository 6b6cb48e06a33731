"""The port's pattern AST (``core/patterns.py``) against the JAX package's.

The twin of ``tests/test_patterns.py``, test for test: each pattern is
built through both packages' factories and must be equal field for field
(θ to the bit), with equal predicate tensors, and the reference's
assertions must hold on the port.
"""

import pytest

from _torch_twin import plain
from repro.core import patterns as jpatterns
from repro_torch.core import patterns


def both(build):
    """``build(patterns module)`` through each package; equal."""
    got, want = build(patterns), build(jpatterns)
    assert plain(got) == plain(want)
    return got, want


def same_tensors(got, want):
    t = got.pred_tensors()
    assert plain(t) == plain(want.pred_tensors())
    return t


def test_seq_basics():
    p, _ = both(lambda m: m.seq_pattern([3, 1, 7], window=5.0))
    assert p.n == 3 and p.is_sequence and p.window == 5.0


def test_pred_tensor_mirroring():
    def build(m):
        preds = (m.Predicate(0, 1, m.PRED_LT, 0, 0, 0.5),
                 m.Predicate(2, 1, m.PRED_GT, 0, 0, 0.1))
        return m.seq_pattern([0, 1, 2], 10.0, preds)

    t = same_tensors(*both(build))
    assert t["op"][0, 1] == patterns.PRED_LT
    assert t["op"][1, 0] == patterns.PRED_GT
    assert t["op"][2, 1] == patterns.PRED_GT
    assert t["op"][1, 2] == patterns.PRED_LT
    assert t["theta"][0, 1] == t["theta"][1, 0] == 0.5
    assert t["op"][0, 2] == patterns.PRED_NONE


def test_abs_pred_self_mirror():
    t = same_tensors(*both(lambda m: m.seq_pattern(
        [0, 1], 1.0, (m.Predicate(0, 1, m.PRED_ABS_LE, 0, 0, 2.0),))))
    assert t["op"][0, 1] == t["op"][1, 0] == patterns.PRED_ABS_LE


def test_selectivity_pairs_upper_triangle():
    p, jp = both(lambda m: m.seq_pattern([0, 1, 2, 3], 1.0,
                                         m.chain_predicates([0, 1, 2, 3])))
    assert p.selectivity_pairs() == jp.selectivity_pairs() == (
        (0, 1), (1, 2), (2, 3))


def test_chain_predicates_semantics():
    c, _ = both(lambda m: m.chain_predicates([5, 6, 7], op=m.PRED_LT,
                                             theta=0.25))
    assert len(c) == 2
    assert c[0].a_type == 5 and c[0].b_type == 6 and c[0].theta == 0.25


@pytest.mark.parametrize("kind", ["neg", "kleene", "and"])
def test_negation_and_kleene_flags(kind):
    build = {
        "neg": lambda m: m.neg_pattern([0, 1], 5.0, negated_type=2,
                                       negated_pos=1),
        "kleene": lambda m: m.kleene_pattern([0, 1, 2], 5.0, kleene_pos=1),
        "and": lambda m: m.and_pattern([0, 1], 5.0),
    }[kind]
    p, jp = both(build)
    same_tensors(p, jp)
    if kind == "neg":
        assert p.negated_type == 2 and p.negated_pos == 1 and p.is_sequence
    elif kind == "kleene":
        assert p.kleene_pos == 1 and p.is_sequence
    else:
        assert not p.is_sequence


def test_composite_window():
    c, jc = both(lambda m: m.CompositePattern((
        m.seq_pattern([0, 1], 3.0), m.seq_pattern([2, 3], 7.0))))
    assert c.window == jc.window == 7.0
