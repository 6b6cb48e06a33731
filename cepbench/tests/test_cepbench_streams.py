"""The benchmark's frozen stream generators draw what the program's do."""

import numpy as np
import pytest

import _tiny  # noqa: F401  (paths)
from cepbench import streams as frozen
from repro_torch.data import cep_streams as live


@pytest.mark.parametrize("kind", ["traffic", "stocks"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_frozen_streams_equal_the_programs(kind, seed):
    kw = dict(n_types=6, chunk_cap=48, n_chunks=40, seed=seed,
              base_rate=30.0, shift_every=10.0)
    ours = list(frozen.STREAMS[kind](frozen.StreamConfig(**kw)))
    theirs = list(live.make_stream(kind, live.StreamConfig(**kw)))
    assert len(ours) == len(theirs) == 40
    for a, b in zip(ours, theirs):
        for f in ("type_id", "ts", "attr", "valid"):
            x, y = getattr(a, f), np.asarray(getattr(b.chunk, f))
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a.t0, a.t1) == (b.t0, b.t1)
