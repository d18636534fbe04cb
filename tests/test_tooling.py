"""Harness tooling: lazy Layouts and the chained-timing witness."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpu_bench.core import timing
from gpu_bench.ops import bwdtrans


def test_layouts_lazy_and_replace():
    calls = []

    def make():
        calls.append(1)
        return np.arange(4)

    lay = bwdtrans.Layouts(base={"a": 7}, derived={"d": make})
    assert lay["a"] == 7
    assert "a" in lay and "d" in lay and "x" not in lay
    d1, d2 = lay["d"], lay["d"]
    assert len(calls) == 2  # fresh per access, never cached
    np.testing.assert_array_equal(d1, d2)

    lay2 = lay.replace(a=9)
    assert lay2["a"] == 9 and lay["a"] == 7
    assert "d" in lay2


def test_witness_sumsq_matches_l2norm():
    from gpu_bench.core.validate import l2norm

    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 1 << 17)),
                    dtype=jnp.float32)
    w = float(timing._witness_sumsq(x))
    assert np.sqrt(w) == pytest.approx(l2norm(x), rel=1e-6)
    # tuple outputs use the first element (multi-output variants)
    w2 = float(timing._witness_sumsq((x, None)))
    assert w2 == pytest.approx(w)
