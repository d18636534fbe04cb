"""b04 correctness: every variant vs the f64 oracle + the reference-log
golden norm (benchmark04/nq8x8.log: nelmt 128 norm 29.12205853)."""

import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark04 as b04
from gpu_bench.core.validate import l2norm
from gpu_bench.ops import bwdtrans


@pytest.mark.parametrize("nq", [2, 3, 8])
def test_variants_match_oracle(nq, cfg64):
    nelmt = 128
    data = b04.prepare(nq, nq, nelmt, cfg64)
    ref = bwdtrans.reference2d(data["basis"], nelmt)
    ref_norm = float(np.linalg.norm(ref))
    for label, fn, args in b04.build_variants(data, cfg64):
        out = fn(*args)
        assert l2norm(out) == pytest.approx(
            ref_norm, rel=1e-10), label
        # shape-aware value check for the element-major einsum tier
        if label == "XLA(Uncoales)":
            np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10)


def test_golden_norm_nq8(cfg64):
    """Reference committed log value (benchmark04/nq8x8.log:3)."""
    data = b04.prepare(8, 8, 128, cfg64)
    _, fn, args = b04.build_variants(data, cfg64)[0]
    assert l2norm(fn(*args)) == pytest.approx(29.12205853,
                                                          rel=1e-8)


@pytest.mark.parametrize("nq", [2, 6, 11])
def test_f32_agreement(nq, cfg32):
    """f32 columns agree with each other at a low, a mid and an odd order
    (nq=11 pads the fused kernel's i axis from 11 to 16 rows)."""
    nelmt = 256
    data = b04.prepare(nq, nq, nelmt, cfg32)
    norms = []
    for label, fn, args in b04.build_variants(data, cfg32):
        norms.append(l2norm(fn(*args)))
    ref = norms[0]
    for label, n in zip(b04.LABELS[1:], norms[1:]):
        assert n == pytest.approx(ref, rel=5e-4), label


def test_high_precision_agreement(cfg32):
    """--precision high: the XLA columns' f32 contractions go through
    config.dot_precision (3-pass TF32 on the GPU, full f32 on the CPU);
    the fused kernel is exact f32 FMAs whatever the precision.  Every
    variant must stay within ~1e-5 of the f64 oracle at a mid order and
    at nq=32."""
    import dataclasses

    import jax

    cfg = dataclasses.replace(cfg32, precision=jax.lax.Precision.HIGH)
    nelmt = 256
    for nq in (6, 32):
        data = b04.prepare(nq, nq, nelmt, cfg)
        ref_norm = float(np.linalg.norm(
            bwdtrans.reference2d(data["basis"], nelmt)))
        for label, fn, args in b04.build_variants(data, cfg):
            got = l2norm(fn(*args))
            assert got == pytest.approx(ref_norm, rel=3e-5), (nq, label)


def test_odd_nelmt_padding(cfg64):
    """nelmt not a multiple of 128 must stay correct: padding elements are
    zeroed, so the norm matches the true element count."""
    nelmt = 200
    data = b04.prepare(4, 4, nelmt, cfg64)
    ref_norm = float(np.linalg.norm(bwdtrans.reference2d(data["basis"], nelmt)))
    for label, fn, args in b04.build_variants(data, cfg64):
        got = l2norm(fn(*args))
        assert got == pytest.approx(ref_norm, rel=1e-10), label


def test_bf16_agreement():
    """bf16 halves HBM traffic; norms agree within the bf16 tolerance."""
    import jax.numpy as jnp

    from gpu_bench.core.config import Config
    from gpu_bench.core.validate import l2norm

    cfg = Config(dtype=jnp.bfloat16, n_tests=2)
    data = b04.prepare(4, 4, 128, cfg)
    norms = [l2norm(fn(*args)) for _, fn, args in b04.build_variants(data, cfg)]
    for label, n in zip(b04.LABELS[1:], norms[1:]):
        assert n == pytest.approx(norms[0], rel=5e-2), label
