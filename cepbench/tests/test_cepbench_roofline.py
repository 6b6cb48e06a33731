"""The frozen roofline arithmetic gives what ``chip_smoke.py``'s gives."""

import importlib.util

import pytest
import torch

from _tiny import REPO
from cepbench import roofline


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,c,m,b", [(3, 6, 64, 40), (128, 14, 256, 1024)])
def test_bounds_equal_the_smoke_scripts(k, c, m, b):
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(k + c)
    L, R = torch.randn(k, c, m, generator=g), torch.randn(k, c, b, generator=g)
    th = torch.randn(c, generator=g)
    ops8 = torch.randint(0, 4, (k, c), generator=g).to(torch.int8)
    mv = torch.rand(k, m, generator=g) < 0.5
    bv = torch.rand(k, b, generator=g) < 0.3
    ops = ops8.to(torch.int32)
    ours, what = roofline.packed_bound(L, R, ops8, th, mv, bv)
    theirs, what2 = smoke.packed_bound(L, R, ops8, th, mv, bv)
    assert ours * 1e3 == pytest.approx(theirs, rel=1e-12) and what == what2
    ours, what = roofline.join_bound(L, R, ops, th)
    theirs, what2 = smoke.join_bound(L, R, ops, th)
    assert ours * 1e3 == pytest.approx(theirs, rel=1e-12) and what == what2
