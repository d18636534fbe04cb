"""b03 correctness: variants vs the f64 matvec oracle + reference-log golden
norms (benchmark03/outfile.log)."""

import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark03 as b03
from gpu_bench.core.validate import l2norm
from gpu_bench.ops import initdata
from gpu_bench.utils import native

# ||A.x|| from /root/reference/benchmark03/outfile.log:5,8
GOLDEN_NORMS = {128: 1053.208334, 256: 3026.150384, 512: 8521.062683}


def _data(size, dtype):
    import jax.numpy as jnp

    a = initdata.host_matrix_sin1((size, size), dtype)
    x = initdata.host_x_linear(size, dtype)
    return {"a_rm": a, "a_cm": jnp.asarray(a.T), "x": x}


def _as_f64(y):
    return np.asarray(y, np.float64)


@pytest.mark.parametrize("size", [128, 256])
def test_variants_match_oracle(size, cfg64):
    data = _data(size, cfg64.dtype)
    expected = native.matvec_ref(np.asarray(data["a_rm"]),
                                 np.asarray(data["x"]))
    for label, fn, args in b03.build_variants(data, cfg64):
        y = _as_f64(fn(*args))
        np.testing.assert_allclose(y, expected, rtol=1e-10, err_msg=label)


@pytest.mark.parametrize("size,norm", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, norm, cfg64):
    data = _data(size, cfg64.dtype)
    _, fn, args = b03.build_variants(data, cfg64)[1]
    assert l2norm(fn(*args)) == pytest.approx(norm, rel=1e-9)


def test_labels_match_specs(cfg32):
    assert [s[0] for s in b03.variant_specs(None, cfg32)] == b03.LABELS


def test_f32_accuracy(cfg32):
    size = 512
    data = _data(size, cfg32.dtype)
    expected = native.matvec_ref(np.asarray(data["a_rm"], np.float64),
                                 np.asarray(data["x"], np.float64))
    ref_norm = float(np.linalg.norm(expected))
    for label, fn, args in b03.build_variants(data, cfg32):
        got = l2norm(fn(*args))
        assert got == pytest.approx(ref_norm, rel=1e-5), label
