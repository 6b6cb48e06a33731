"""The paper's ``seq`` pattern set, as plain data and as the program's
pattern.

``plain`` is a frozen copy of ``benchmarks/torch_common.py::build_pattern``
for the ``seq`` set: types ``0 .. size-1`` in this order, the
adjacent-pair predicates ``a[p-1] < a[p] + theta`` on attribute 0, one
time window.  The reference reads this description; ``program`` turns the
same description into the program's ``Pattern``.
"""

from __future__ import annotations

from typing import Dict

OPS = {"lt": 1, "gt": 2, "abs_le": 3}


def plain(spec: Dict) -> Dict:
    """``{"operator", "types", "window", "predicates"}`` with predicates
    as ``(position a, position b, op, theta)``."""
    size = int(spec["size"])
    theta = float(spec.get("theta", -0.3))
    return {
        "operator": "SEQ",
        "types": list(range(size)),
        "window": float(spec.get("window", 4.0)),
        "predicates": [(p - 1, p, "lt", theta) for p in range(1, size)],
    }


def program(plain: Dict):
    """The program's ``Pattern`` for a plain description."""
    from repro_torch.core.patterns import Predicate, seq_pattern

    types = plain["types"]
    preds = [Predicate(types[a], types[b], OPS[op], 0, 0, theta)
             for (a, b, op, theta) in plain["predicates"]]
    return seq_pattern(types, plain["window"], preds)
