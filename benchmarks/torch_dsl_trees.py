"""Random ``P`` DSL trees and short random streams, for either package.

A copy of the generators of ``tests/test_dsl_prop.py`` (``random_branch``,
``random_tree``, ``random_records``), parametrised by the DSL's ``P`` and
the stream module's ``emit_chunk`` so that one seed builds the same tree
and the same records through the port (the defaults) or through any other
package with the same DSL.  The draw order is the test's, call for call:
the same seed gives the same ``str(branch.build())`` and the same record
arrays.

The trees span the DSL: an ``or_`` of 2-3 branches (probability 0.35) or
one branch; a branch is an ``and_`` of 2-3 distinct types, or a ``seq``
that may carry a negation at any position (the ends included) or a
Kleene closure with bound 2-3; adjacent positions are chained by ``<`` /
``>`` predicates with θ in (-0.5, 0.8); windows lie in (3, 8).

``K1_SEEDS`` and ``K3_SEEDS`` are the seeds the test's ``@given`` draws
under hypothesis 6.142.1 (``derandomize=True``) when its file runs alone
(``pytest tests/test_dsl_prop.py``, the same on every run): 12 at K = 1,
6 at K = 3, where the test seeds its generator at ``seed + K3_OFFSET``.
Hypothesis biases its draws by literals it collects from the loaded
modules, so in a process that has loaded others the test may draw other
seeds; these stay fixed.  ``case(seed, k)`` rebuilds one.
"""

from __future__ import annotations

import numpy as np

N_TYPES = 4
K1_SEEDS = (0, 7474, 2745, 4269, 7153, 5908, 7056, 3887, 3482, 8416, 4084,
            6080)
K3_SEEDS = (0, 228, 6722, 6486, 7730, 4065)
K3_OFFSET = 77
N_CHUNKS = 3
CHUNK_CAP = 128


def _port_P():
    from repro_torch.cep import P

    return P


def _port_emit_chunk():
    from repro_torch.data.cep_streams import emit_chunk

    return emit_chunk


def random_branch(rng, P=None):
    """One non-composite builder: a decorated seq or and_ pattern."""
    P = P or _port_P()
    n = int(rng.integers(2, 4))
    type_ids = list(rng.choice(N_TYPES, n, replace=False))
    kind = rng.random()
    window = float(rng.uniform(3.0, 8.0))
    if kind < 0.35:                       # plain AND conjunction
        b = P.and_(*type_ids)
    else:                                 # sequence, maybe neg/kleene
        elements = [int(t) for t in type_ids]
        deco = rng.random()
        if deco < 0.3 and n >= 2:
            spare = [t for t in range(N_TYPES) if t not in type_ids]
            if spare:
                pos = int(rng.integers(0, n + 1))
                elements.insert(pos, P.neg(int(spare[0])))
        elif deco < 0.6:
            pos = int(rng.integers(0, n))
            elements[pos] = P.kleene(elements[pos],
                                     bound=int(rng.integers(2, 4)))
        b = P.seq(*elements)
    # chained pairwise predicates between adjacent positive positions
    conds = []
    for p in range(n - 1):
        if rng.random() < 0.7:
            theta = float(rng.uniform(-0.5, 0.8))
            a, c = P.attr(p), P.attr(p + 1)
            conds.append(a < c + theta if rng.random() < 0.5
                         else a > c - theta)
    if conds:
        b = b.where(*conds)
    return b.within(window)


def random_tree(rng, P=None):
    """A random DSL tree of depth <= 3; returns (builder, branch builders)."""
    P = P or _port_P()
    if rng.random() < 0.35:
        branches = [random_branch(rng, P)
                    for _ in range(int(rng.integers(2, 4)))]
        return P.or_(*branches), branches
    b = random_branch(rng, P)
    return b, [b]


def random_records(rng, emit_chunk=None, n_chunks=N_CHUNKS,
                   chunk_cap=CHUNK_CAP):
    """``n_chunks`` one-second chunks of Poisson arrivals at random rates
    and attribute means."""
    emit_chunk = emit_chunk or _port_emit_chunk()
    recs = []
    for c in range(n_chunks):
        rates = rng.uniform(1.0, 6.0, N_TYPES)
        attr_mean = rng.normal(0.0, 0.5, (N_TYPES, 1))
        recs.append(emit_chunk(rng, rates, attr_mean, float(c),
                               chunk_duration=1.0, chunk_cap=chunk_cap))
    return recs


def case(seed, k, P=None, emit_chunk=None):
    """The property test's case for ``seed`` at ``k`` partitions (1 or 3):
    (tree, branches, streams); at k = 1 ``streams`` is one record list,
    at k = 3 a list of three."""
    if k == 1:
        rng = np.random.default_rng(seed)
        tree, branches = random_tree(rng, P)
        return tree, branches, random_records(rng, emit_chunk)
    rng = np.random.default_rng(seed + K3_OFFSET)
    tree, branches = random_tree(rng, P)
    return tree, branches, [random_records(rng, emit_chunk)
                            for _ in range(k)]

