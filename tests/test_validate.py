"""Validation layer: norm agreement, failure isolation, l2norm accuracy."""

import numpy as np
import pytest

from gpu_bench.core import validate
from gpu_bench.core.reporting import Reporter


def test_norm_agreement_flags_mismatch():
    msgs = validate.check_norm_agreement(["a", "b", "c"], [1.0, 1.0, 1.1],
                                         rtol=1e-3, context="t")
    assert len(msgs) == 1 and "c" in msgs[0]


def test_norm_agreement_skips_failed_variants():
    msgs = validate.check_norm_agreement(["a", "b"], [1.0, float("nan")],
                                         rtol=1e-3)
    assert msgs == []


def test_measure_checked_isolates_failure(capsys, cfg32):
    notes = []
    rep = Reporter.__new__(Reporter)
    rep.note = notes.append

    def boom(*a):
        raise RuntimeError("out of memory (synthetic)")

    t, norm = validate.measure_checked("X", boom, (1,), cfg32, rep)
    assert t == float("inf") and norm != norm
    assert notes and "X failed" in notes[0]


def test_measure_checked_passes_through(cfg32):
    import jax.numpy as jnp

    rep = Reporter.__new__(Reporter)
    rep.note = lambda m: (_ for _ in ()).throw(AssertionError(m))
    fn = lambda x: x * 2.0
    t, norm = validate.measure_checked("ok", fn, (jnp.ones(8),), cfg32, rep)
    assert t > 0 and norm == pytest.approx(np.sqrt(8 * 4.0))


def test_l2norm_large_f32_accuracy():
    import jax.numpy as jnp

    x = jnp.full((1 << 22,), 0.1, jnp.float32)
    want = np.sqrt((1 << 22) * 0.01)
    assert validate.l2norm(x) == pytest.approx(want, rel=1e-6)
