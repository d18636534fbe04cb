"""Fused 3D BwdTrans kernel (benchmark05's Pallas(QP/Shared)) in interpret
mode against the f64 NumPy reference, at every b05 order and dtype."""

import pytest

from gpu_bench.kernels import bwdtrans as pl_bt
from kernel_cases import B05_ORDERS, DTYPES, TOL, random_case, rel_err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq", B05_ORDERS)
def test_kernel_matches_reference(nq, dtype):
    # 24 elements at te=16: one full tile and a masked 8-element tail
    x, bases, ref = random_case(3, nq, 24, dtype)
    out = pl_bt.sum_factorization(x, *bases, te=16, interpret=True)
    assert out.shape == ref.shape and out.dtype == x.dtype
    assert rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("nelmt,te", [(3, 16), (33, 32)])
def test_masked_tails(nelmt, te):
    x, bases, ref = random_case(3, 4, nelmt, "float64", seed=nelmt)
    out = pl_bt.sum_factorization(x, *bases, te=te, interpret=True)
    assert rel_err(out, ref) <= TOL["float64"]


def test_rejects_other_ranks():
    import jax.numpy as jnp

    with pytest.raises(ValueError):
        pl_bt.sum_factorization(jnp.zeros((2, 8)), jnp.zeros((2, 3)),
                                interpret=True)
