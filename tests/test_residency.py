"""Large-sweep residency machinery: lazy per-layout
stream sources, XLA-tier element chunking, and the scalar-carry timing chain
must all be exactly value-preserving."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_bench.baselines import bwdtrans2d as xla2d
from gpu_bench.baselines import bwdtrans3d as xla3d
from gpu_bench.core import timing
from gpu_bench.ops import bwdtrans


def test_stream_sources_match_make_inputs_2d():
    basis = bwdtrans.make_basis2d(5, 4, jnp.float32)
    nelmt, e_pad = 200, 256
    in_em2, in_coa = bwdtrans.make_inputs2d(basis, nelmt, e_pad, jnp.float32)
    src = bwdtrans.stream_sources(
        bwdtrans.element_data2d(basis, jnp.float32),
        (basis.nm1, basis.nm0), nelmt, e_pad, jnp.float32)
    np.testing.assert_array_equal(np.asarray(src["em2"]()), np.asarray(in_em2))
    np.testing.assert_array_equal(np.asarray(src["coa"]()), np.asarray(in_coa))
    # padding elements beyond nelmt are zero in both layouts
    assert not np.asarray(src["coa"]())[:, nelmt:].any()


def test_stream_sources_match_make_inputs_3d():
    basis = bwdtrans.make_basis3d(3, 4, 5, jnp.float32)
    nelmt = e_pad = 128
    in_em2, in_coa = bwdtrans.make_inputs3d(basis, nelmt, e_pad, jnp.float32)
    src = bwdtrans.stream_sources(
        bwdtrans.element_data3d(basis, jnp.float32),
        (basis.nm2, basis.nm1, basis.nm0), nelmt, e_pad, jnp.float32)
    np.testing.assert_array_equal(np.asarray(src["em2"]()), np.asarray(in_em2))
    np.testing.assert_array_equal(np.asarray(src["coa"]()), np.asarray(in_coa))
    assert sorted(src) == ["coa", "em2"]


@pytest.mark.parametrize("axis", [0, -1])
def test_chunk_elems_value_preserving(axis):
    basis = bwdtrans.make_basis2d(4, 4, jnp.float32)
    e = 512
    in_em2, in_coa = bwdtrans.make_inputs2d(basis, e, e, jnp.float32)
    if axis == 0:
        fn, args = xla2d.staged_em, (in_em2.reshape(e, basis.nm1, basis.nm0),
                                     basis.b0, basis.b1)
    else:
        fn, args = xla2d.einsum_coa, (in_coa.reshape(basis.nm1, basis.nm0, e),
                                      basis.b0, basis.b1)
    want = fn(*args)
    got = xla2d.chunk_elems(fn, 128, axis)(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    # a chunk width >= the element count must be a no-op passthrough
    same = xla2d.chunk_elems(fn, 4096, axis)(*args)
    np.testing.assert_array_equal(np.asarray(same), np.asarray(want))


def test_chunk_elems_3d_gemm_kron():
    basis = bwdtrans.make_basis3d(3, 3, 3, jnp.float32)
    e = 256
    _, in_coa = bwdtrans.make_inputs3d(basis, e, e, jnp.float32)
    c_em3 = bwdtrans.operator3d(basis)
    c_coa3 = jnp.asarray(c_em3.T)
    want = xla3d.gemm_kron(in_coa, c_coa3)
    got = xla2d.chunk_elems(xla3d.gemm_kron, 64, -1)(in_coa, c_coa3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_scalar_carry_chain_matches_array_carry():
    """Same witness (= sumsq of one plain application) from both carry
    modes, at several chain lengths."""

    def fn(x, y):
        return x * 2.0 + y

    x = jnp.arange(32.0, dtype=jnp.float32).reshape(4, 8)
    y = jnp.ones((4, 8), jnp.float32)
    chain = timing.eps_chain(fn, eps_arg=1)
    run_arr = timing.build_chain(chain, carry="array")
    run_sca = timing.build_chain(chain, carry="scalar")
    want = float(jnp.sum(fn(x, y) ** 2))
    for k in (1, 2, 7):
        assert float(run_arr(jnp.int32(k), x, y)) == pytest.approx(want)
        assert float(run_sca(jnp.int32(k), x, y)) == pytest.approx(want)


def test_choose_xla_chunk():
    # plenty of room: no chunking
    assert bwdtrans.choose_xla_chunk(10, 1, 1 << 20, 1 << 62) is None
    # forced chunking: power-of-two >= 64Ki, fits the cap model
    e_pad = 1 << 20
    fixed = 12 << 30
    w = 992 * 4
    cap = 13 << 30
    ce = bwdtrans.choose_xla_chunk(fixed, w, e_pad, cap)
    assert ce is not None and ce >= 65536 and (ce & (ce - 1)) == 0
    assert fixed + 2 * w * ce <= cap
