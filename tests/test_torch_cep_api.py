"""The port's ``repro_torch.cep`` surface against ``repro.cep``.

The twin of ``tests/test_cep_api.py``, test for test: the ``__all__``
contract, the DSL compiling to the same ``Pattern`` as the hand-assembled
``core.patterns`` factories in both packages (every field, θ to the bit,
and the predicate tensors), θ folding, OR composites, ``n_attrs``
inference, immutable builders, every DSL misuse raising the same
exception with the same message, and the ``RuntimeConfig`` adapters
(where the port's ``config.py`` adds ``device``: the port's sessions here
ask for ``device="cpu"``).
"""

import pytest

from _torch_twin import plain
from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.core import patterns as jpatterns
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig
from repro_torch.core import patterns
from test_cep_api import DOCUMENTED_SURFACE


def same_pattern(got, want):
    """Every field equal to the bit, and so are the predicate tensors."""
    assert plain(got) == plain(want)
    if hasattr(want, "pred_tensors"):
        assert plain(got.pred_tensors()) == plain(want.pred_tensors())


def both(build):
    """``build(P, patterns)`` through each package: (port, JAX)."""
    return build(P, patterns), build(JP, jpatterns)


def test_public_surface_matches_documentation():
    assert set(cep.__all__) == set(jcep.__all__) == DOCUMENTED_SURFACE
    for name in cep.__all__:
        assert getattr(cep, name) is not None


def test_seq_dsl_equals_factory():
    def build(P_, pat):
        built = (P_.seq(0, 1, 2)
                 .where(P_.attr(0) < P_.attr(1) - 0.3,
                        P_.attr(1) < P_.attr(2) - 0.3)
                 .within(4.0).named("seq").build())
        return built, pat.seq_pattern(
            [0, 1, 2], 4.0, pat.chain_predicates([0, 1, 2], theta=-0.3))

    (got, factory), (jgot, jfactory) = both(build)
    assert got == factory
    same_pattern(got, jgot)
    same_pattern(factory, jfactory)


def test_and_dsl_equals_factory():
    def build(P_, pat):
        built = (P_.and_(3, 1, 2)
                 .where(P_.attr(0) < P_.attr(1) + 0.4,
                        P_.attr(1) < P_.attr(2) + 0.4)
                 .within(15.0).named("and").build())
        return built, pat.and_pattern(
            [3, 1, 2], 15.0, pat.chain_predicates([3, 1, 2], theta=0.4))

    (got, factory), (jgot, jfactory) = both(build)
    assert got == factory
    same_pattern(got, jgot)
    same_pattern(factory, jfactory)


def test_theta_folding_and_ops():
    def build(P_, pat):
        built = (P_.seq(0, 1)
                 .where(P_.attr(0, 1) > P_.attr(1, 0) - 0.2,
                        abs(P_.attr(0) - P_.attr(1)) <= 1.5)
                 .within(9.0).build())
        return built, ((P_.attr(0) - 1.0) < P_.attr(1)).theta

    (got, lt), (jgot, jlt) = both(build)
    assert got.predicates == (
        patterns.Predicate(0, 1, patterns.PRED_GT, 1, 0, pytest.approx(0.2)),
        patterns.Predicate(0, 1, patterns.PRED_ABS_LE, 0, 0, 1.5),
    )
    same_pattern(got, jgot)
    assert lt == pytest.approx(1.0)
    assert float.hex(lt) == float.hex(jlt)


def test_neg_dsl_equals_factory():
    def build(P_, pat):
        built = (P_.seq(0, P_.neg(2), 1)
                 .where(P_.attr(0) < P_.attr(1) + 0.5,
                        P_.neg_attr(0) > P_.attr(0) + 1.0)
                 .within(20.0).named("neg").build())
        return built, pat.neg_pattern(
            [0, 1], 20.0, negated_type=2, negated_pos=1,
            predicates=(pat.Predicate(0, 1, pat.PRED_LT, 0, 0, 0.5),),
            negated_predicates=(pat.Predicate(2, 0, pat.PRED_GT, 0, 0,
                                              -1.0),))

    (got, factory), (jgot, jfactory) = both(build)
    assert got == factory
    assert got.operator is patterns.Operator.NEG
    same_pattern(got, jgot)
    same_pattern(factory, jfactory)


def test_kleene_dsl_equals_factory():
    def build(P_, pat):
        built = (P_.seq(0, P_.kleene(1, bound=2), 2)
                 .within(20.0).attrs(1).named("kleene").build())
        return built, pat.kleene_pattern([0, 1, 2], 20.0, kleene_pos=1,
                                         kleene_bound=2)

    (got, factory), (jgot, jfactory) = both(build)
    assert got == factory
    same_pattern(got, jgot)
    same_pattern(factory, jfactory)


def test_or_composite_build():
    def build(P_, pat):
        b1 = P_.seq(0, 1).within(5.0)
        b2 = P_.and_(2, 3).within(7.0)
        return P_.or_(b1, b2).named("either").build(), (b1.build(),
                                                        b2.build())

    (comp, branches), (jcomp, _) = both(build)
    assert isinstance(comp, patterns.CompositePattern)
    assert comp.branches == branches
    assert comp.window == 7.0
    same_pattern(comp, jcomp)


def test_n_attrs_inferred_from_predicates():
    def build(P_, pat):
        return ((P_.seq(0, 1).where(P_.attr(0, 2) < P_.attr(1, 0))
                 .within(5.0).build()),
                P_.seq(0, 1).within(5.0).build())

    (wide, narrow), (jwide, jnarrow) = both(build)
    assert wide.n_attrs == 3 and narrow.n_attrs == 1
    same_pattern(wide, jwide)
    same_pattern(narrow, jnarrow)


def test_builders_are_immutable():
    def build(P_, pat):
        base = P_.seq(0, 1).within(5.0)
        refined = base.where(P_.attr(0) < P_.attr(1))
        return base.build(), refined.build()

    (base, refined), (jbase, jrefined) = both(build)
    assert base.predicates == ()
    assert len(refined.predicates) == 1
    same_pattern(base, jbase)
    same_pattern(refined, jrefined)


# (exception, the reference's match, misuse through (P, cep, config)).
DSL_ERRORS = [
    (ValueError, "window", lambda P_, c, cfg: P_.seq(0, 1).build()),
    (TypeError, "strict",
     lambda P_, c, cfg: P_.seq(0, 1).where(P_.attr(0) <= P_.attr(1))
     .within(5.0)),
    (TypeError, "two attribute references",
     lambda P_, c, cfg: P_.attr(0) < 1.0),
    (ValueError, "distinct",
     lambda P_, c, cfg: P_.seq(0, 0, 1).within(5.0).build()),
    (ValueError, "out of range",
     lambda P_, c, cfg: P_.seq(0, 1).where(P_.attr(2) < P_.attr(0))
     .within(5.0).build()),
    (ValueError, "no negated element",
     lambda P_, c, cfg: P_.seq(0, 1).where(P_.neg_attr() < P_.attr(0))
     .within(5.0).build()),
    (ValueError, "at most one negated",
     lambda P_, c, cfg: P_.seq(0, P_.neg(1), P_.neg(2), 3).within(5.0)
     .build()),
    (ValueError, "require P.seq",
     lambda P_, c, cfg: P_.and_(0, P_.neg(1), 2).within(5.0).build()),
    (ValueError, "cannot be combined",
     lambda P_, c, cfg: P_.seq(0, P_.neg(1), P_.kleene(2), 3).within(5.0)
     .build()),
    (ValueError, "at least two branches",
     lambda P_, c, cfg: P_.or_(P_.seq(0, 1).within(5.0))),
    (ValueError, "shifts",
     lambda P_, c, cfg: abs((P_.attr(0) + 1.0) - P_.attr(1)) <= 0.5),
    (TypeError, None, lambda P_, c, cfg: c.open(42, config=cfg())),
    # Python rewrites a < b < c as (a < b) and (b < c): truth-testing the
    # first Cond would silently drop it, so Cond refuses to be a boolean.
    (TypeError, "chained",
     lambda P_, c, cfg: P_.attr(0) < P_.attr(1) < P_.attr(2)),
]


def port_cfg(**kw):
    return RuntimeConfig(device="cpu", **kw)


def P_of(c):
    """The DSL of the package whose ``cep`` module is ``c``."""
    return P if c is cep else JP


def test_dsl_errors():
    """Every misuse raises the reference's exception in both packages,
    with the same message."""
    for kind, match, misuse in DSL_ERRORS:
        with pytest.raises(kind, match=match) as jexc:
            misuse(JP, jcep, JConfig)
        with pytest.raises(kind, match=match) as exc:
            misuse(P, cep, port_cfg)
        assert str(exc.value) == str(jexc.value), match


def test_runtime_config_adapters():
    kw = dict(buffer_capacity=32, match_capacity=64, policy="threshold",
              policy_kw={"t": 0.25})
    cfg, jcfg = RuntimeConfig(device="cpu", **kw), JConfig(**kw)
    eng, jeng = cfg.engine(), jcfg.engine()
    assert (eng.b_cap, eng.m_cap) == (jeng.b_cap, jeng.m_cap) == (32, 64)
    assert (eng.backend, eng.device) == (None, "cpu")
    pol, jpol = cfg.policy_factory()(), jcfg.policy_factory()()
    assert pol.name == jpol.name == "threshold"
    assert pol.t == jpol.t == 0.25
    assert RuntimeConfig(policy=None).policy_factory() is None
    assert JConfig(policy=None).policy_factory() is None
    cases = [
        (ValueError, "match_capacity",
         lambda C, c: C(buffer_capacity=128, match_capacity=64)),
        (ValueError, "unknown policy", lambda C, c: C(policy="bogus")),
        (ValueError, "invariant",
         lambda C, c: c.open(P_of(c).seq(0, 1).within(5.0), monitor=True,
                             config=C(policy="threshold"))),
        (ValueError, "order",
         lambda C, c: c.open(P_of(c).seq(0, 1).within(5.0),
                             plan="sideways", config=C())),
    ]
    for kind, match, misuse in cases:
        with pytest.raises(kind, match=match) as jexc:
            misuse(JConfig, jcep)
        with pytest.raises(kind, match=match) as exc:
            misuse(port_cfg, cep)
        assert str(exc.value) == str(jexc.value), match

