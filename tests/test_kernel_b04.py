"""Fused 2D BwdTrans kernel (benchmark04's Pallas(QP/Shared)) in interpret
mode against the f64 NumPy reference, at every b04 order and dtype."""

import pytest

from gpu_bench.kernels import bwdtrans as pl_bt
from kernel_cases import B04_ORDERS, DTYPES, TOL, random_case, rel_err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq", B04_ORDERS)
def test_kernel_matches_reference(nq, dtype):
    # 40 elements at te=16: two full tiles and a masked 8-element tail
    x, bases, ref = random_case(2, nq, 40, dtype)
    out = pl_bt.sum_factorization(x, *bases, te=16, interpret=True)
    assert out.shape == ref.shape and out.dtype == x.dtype
    assert rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("nelmt,te", [(1, 16), (17, 16), (100, 32),
                                      (129, 64), (64, 64)])
def test_masked_tails(nelmt, te):
    """Element counts that are not a multiple of the tile: the last program
    loads zeros and stores nothing past the end of the stream."""
    x, bases, ref = random_case(2, 5, nelmt, "float64", seed=nelmt)
    out = pl_bt.sum_factorization(x, *bases, te=te, interpret=True)
    assert rel_err(out, ref) <= TOL["float64"]


def test_anisotropic_orders():
    """nq0 != nq1: the padded i axis follows nq0 only."""
    import numpy as np

    x, bases, ref = random_case(2, 6, 48, "float64")
    rng = np.random.default_rng(3)
    import jax.numpy as jnp

    from gpu_bench.utils import native

    b1 = jnp.asarray(rng.uniform(-1, 1, (3, 4)))
    x = x[: 5 * 3]
    out = pl_bt.sum_factorization(x, bases[0], b1, te=16, interpret=True)
    x64 = np.asarray(x).T.reshape(48, 3, 5)
    want = native.bwdtrans2d_ref(x64, np.asarray(bases[0]),
                                 np.asarray(b1)).reshape(48, -1).T
    assert rel_err(out, want) <= TOL["float64"]
