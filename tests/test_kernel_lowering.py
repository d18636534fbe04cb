"""The fused kernel lowers through Pallas' Triton route for CUDA at every
cell's shapes.  The Triton lowering refuses non-power-of-two tensors (which
interpret mode accepts), so this is what catches a shape the card would
refuse; it runs on the CPU, no GPU needed."""

import functools

import jax
import jax.numpy as jnp
import pytest

from gpu_bench.kernels import bwdtrans as pl_bt
from kernel_cases import B04_ORDERS, B05_ORDERS

NELMT = 1 << 20  # the top of the b04/b05 sweeps


def _lower(dim, nq, dtype):
    nm = nq - 1
    args = (jax.ShapeDtypeStruct((nm ** dim, NELMT), dtype),) + tuple(
        jax.ShapeDtypeStruct((nm, nq), dtype) for _ in range(dim))
    fn = functools.partial(pl_bt.sum_factorization, interpret=False)
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


CASES = ([(2, nq) for nq in B04_ORDERS] + [(3, nq) for nq in B05_ORDERS])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim,nq", CASES)
def test_lowers_for_cuda(dim, nq, dtype):
    # the test session runs with x64 on (conftest), so f64 stays f64
    assert "triton" in _lower(dim, nq, jnp.dtype(dtype))


@pytest.mark.parametrize("nq,itemsize", [(2, 4), (8, 4), (10, 8), (32, 4),
                                         (32, 8), (8, 2)])
def test_element_tile(nq, itemsize):
    for dims in ((nq, nq), (nq, nq, nq)):
        te, nw = pl_bt.element_tile(dims, itemsize)
        assert te & (te - 1) == 0 and 8 <= te <= 128
        assert nw & (nw - 1) == 0 and 1 <= nw <= 16
        # never more threads than one (nq0p, te) accumulator has values
        assert 32 * nw <= pl_bt.pl.next_power_of_2(nq) * te
    # the measured H100 optima at the benchmark orders (PERF.md)
    assert pl_bt.element_tile((8, 8, 8), 4) == (64, 8)
    assert pl_bt.element_tile((8, 8, 8), 8) == (32, 8)
    assert pl_bt.element_tile((8, 8), 4) == (32, 1)
    # bf16 accumulates in f32 registers: the f32 tile
    assert pl_bt.element_tile((10, 10), 2) == pl_bt.element_tile((10, 10), 4)
    # anisotropic orders and a given --epb take the formula; --epb is
    # floored to a power of two
    assert pl_bt.element_tile((8, 7, 8), 4) == (64, 8)
    assert pl_bt.element_tile((8, 8, 8), 4, te=48) == (32, 4)


def test_measured_tiles_are_legal():
    """Every measured tile obeys the formula's own limits."""
    for (dim, nq, words), (te, nw) in pl_bt._MEASURED.items():
        assert te & (te - 1) == 0 and 8 <= te <= 128, (dim, nq)
        assert nw & (nw - 1) == 0 and 1 <= nw <= 16, (dim, nq)
        assert 32 * nw <= pl_bt.pl.next_power_of_2(nq) * te, (dim, nq)
