"""b02 correctness: in-place accumulation semantics and golden norms.

The reference's printed norm is ||x0 + 40*y|| because the validation norm is
computed after the 40 timed accumulating reps (benchmark02/benchmark02.cc:
161-164); goldens from benchmark02/outfile.log.
"""

import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark02 as b02
from gpu_bench.core.variants import Layouts
from gpu_bench.core.validate import l2norm
from gpu_bench.ops import initdata
from gpu_bench.utils import native


# ||x0 + 40 y|| from /root/reference/benchmark02/outfile.log:5,8
GOLDEN_NORMS = {1024: 5979.883197, 2048: 8481.399219}


def _data(size, cfg):
    return Layouts(
        base={"y": initdata.device_y(size, cfg.dtype)},
        derived={"x": lambda: initdata.device_x(size, cfg.dtype)})


@pytest.mark.parametrize("size", [1024, 4096])
def test_variants_accumulate(size, cfg64):
    x_host = native.init_mod13(size)
    y_host = native.init_mod8(size)
    n_reps = cfg64.n_tests
    expected = float(np.linalg.norm(x_host + n_reps * y_host))
    data = _data(size, cfg64)
    for label, fn, keys in b02.variant_specs(data, cfg64):
        _, x_final = b02._time_accumulating(fn, cfg64, data, *keys)
        assert l2norm(x_final) == pytest.approx(expected, rel=1e-12), label


@pytest.mark.parametrize("size,norm", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, norm, cfg64):
    cfg64.n_tests = 40  # goldens assume the reference's 40 reps
    data = _data(size, cfg64)
    _, fn, keys = b02.variant_specs(data, cfg64)[1]
    _, x_final = b02._time_accumulating(fn, cfg64, data, *keys)
    assert l2norm(x_final) == pytest.approx(norm, rel=1e-9)


def test_labels_match_specs(cfg32):
    assert [s[0] for s in b02.variant_specs(None, cfg32)] == b02.LABELS
