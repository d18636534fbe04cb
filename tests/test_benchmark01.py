"""b01 correctness: every variant vs the f64 oracle, plus golden norms from
the committed reference logs (benchmark01/outfile.log)."""

import math

import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark01 as b01
from gpu_bench.ops import initdata
from gpu_bench.utils import native

# sqrt(sum x^2) values from /root/reference/benchmark01/outfile.log:5,9
GOLDEN_NORMS = {1024: 231.3925755, 2048: 327.7035849, 4096: 464.5263377}


def _data(size, cfg):
    return {"x": initdata.device_x(size, cfg.dtype)}


@pytest.mark.parametrize("size", [1024, 4096])
def test_variants_match_oracle(size, cfg64):
    x_host = native.init_mod13(size)
    expected = float(np.sqrt(np.sum(x_host * x_host)))
    for label, fn, args in b01.build_variants(_data(size, cfg64), cfg64):
        got = math.sqrt(float(fn(*args)))
        assert got == pytest.approx(expected, rel=1e-12), label


@pytest.mark.parametrize("size,norm", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, norm, cfg64):
    data = _data(size, cfg64)
    _, fn, args = b01.build_variants(data, cfg64)[0]
    got = math.sqrt(float(fn(*args)))
    assert got == pytest.approx(norm, rel=1e-9)


def test_f32_accuracy(cfg32):
    size = 8192
    x_host = native.init_mod13(size)
    expected = float(np.sqrt(np.sum(x_host * x_host)))
    data = {"x": initdata.device_x(size, cfg32.dtype)}
    for label, fn, args in b01.build_variants(data, cfg32):
        got = math.sqrt(float(fn(*args)))
        assert got == pytest.approx(expected, rel=1e-5), label


def test_labels_match_specs(cfg32):
    assert [s[0] for s in b01.variant_specs(None, cfg32)] == b01.LABELS


def test_chained_timing_protocol(cfg32):
    """The chained timer must produce a sane positive per-application time."""
    from gpu_bench.core.timing import build_chain, time_chained

    import jax.numpy as jnp

    x = initdata.device_x(65536, cfg32.dtype)
    _, fn, _ = b01.build_variants({"x": x}, cfg32)[0]
    run_k = build_chain(fn)
    t, witness = time_chained(run_k, (x,), n_tests=8)
    assert 0 < t < 1.0
    # the witness squares b01's sumsq output: norm = witness ** 0.25
    want = float(jnp.sqrt(fn(x)))
    assert math.isclose(witness ** 0.25, want, rel_tol=1e-5)


def test_per_from_window_never_fabricates_throughput():
    """A noise-inverted window (best_hi < best_lo) must fall back to the
    conservative whole-chain bound, never a 1e-12 clamp."""
    from gpu_bench.core.timing import _per_from_window

    # healthy window: plain differencing
    assert _per_from_window(0.9, 0.1, 512, 64) == pytest.approx(0.8 / 448)
    # inverted window: whole-chain upper bound on per-rep time
    assert _per_from_window(0.1, 0.2, 512, 64) == pytest.approx(0.1 / 512)
    # zero window: same fallback
    assert _per_from_window(0.2, 0.2, 512, 64) == pytest.approx(0.2 / 512)
