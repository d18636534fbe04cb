"""b05 correctness: every variant vs the f64 oracle + the reference-log
golden norm (benchmark05/nq8x8x8.log: nelmt 128 norm 189.3141665)."""

import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark05 as b05
from gpu_bench.core.validate import l2norm
from gpu_bench.ops import bwdtrans


@pytest.mark.parametrize("nq", [2, 3, 6])
def test_variants_match_oracle(nq, cfg64):
    nelmt = 128
    data = b05.prepare(nq, nq, nq, nelmt, cfg64)
    ref = bwdtrans.reference3d(data["basis"], nelmt)
    ref_norm = float(np.linalg.norm(ref))
    for label, fn, args in b05.build_variants(data, cfg64):
        out = fn(*args)
        assert l2norm(out) == pytest.approx(
            ref_norm, rel=1e-10), label
        if label == "XLA(Uncoales)":
            np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-9)


def test_mixed_nq(cfg64):
    """Anisotropic quadrature orders exercise the index bookkeeping."""
    data = b05.prepare(3, 4, 5, 128, cfg64)
    ref_norm = float(np.linalg.norm(bwdtrans.reference3d(data["basis"], 128)))
    for label, fn, args in b05.build_variants(data, cfg64):
        assert l2norm(fn(*args)) == pytest.approx(
            ref_norm, rel=1e-10), label


def test_golden_norm_nq8(cfg64):
    """Reference committed log value (benchmark05/nq8x8x8.log:3)."""
    data = b05.prepare(8, 8, 8, 128, cfg64)
    _, fn, args = b05.build_variants(data, cfg64)[0]
    assert l2norm(fn(*args)) == pytest.approx(189.3141665,
                                                          rel=1e-8)


@pytest.mark.parametrize("nq", [2, 4, 8])
def test_f32_agreement(nq, cfg32):
    """f32 columns agree with each other at low and high order."""
    data = b05.prepare(nq, nq, nq, 256, cfg32)
    norms = [l2norm(fn(*args)) for _, fn, args in b05.build_variants(data, cfg32)]
    for label, n in zip(b05.LABELS[1:], norms[1:]):
        assert n == pytest.approx(norms[0], rel=5e-4), label


def test_bf16_f32v_accuracy():
    """The fused kernel accumulates bf16 inputs in f32 registers: the only
    rounding left is the input cast and the final store, so the norm error
    vs the f64 oracle stays well inside the single-cast bf16 bound."""
    import jax.numpy as jnp

    from gpu_bench.core.config import Config
    from gpu_bench.kernels import bwdtrans as pl_bt

    cfg = Config(dtype=jnp.bfloat16, n_tests=2)
    nq, nelmt = 6, 256
    data = b05.prepare(nq, nq, nq, nelmt, cfg)
    ref_norm = float(np.linalg.norm(bwdtrans.reference3d(data["basis"],
                                                         nelmt)))
    out = pl_bt.sum_factorization(data["in_coa"], data["b0"], data["b1"],
                                  data["b2"], interpret=True)
    assert l2norm(out) == pytest.approx(ref_norm, rel=5e-4)
