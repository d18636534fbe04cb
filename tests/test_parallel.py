"""Multi-device sharding tests on the 8-way virtual CPU mesh: the sharded
kron apply and the dp-sharded Pallas kernel must match single-device norms."""

import functools

import jax
import numpy as np
import pytest

from gpu_bench.benchmarks import benchmark05 as b05
from gpu_bench.ops import bwdtrans
from gpu_bench.parallel import mesh as pmesh


@pytest.fixture
def data(cfg64):
    return b05.prepare(4, 4, 4, 512, cfg64)


def test_sharded_kron_matches(data):
    assert len(jax.devices()) == 8
    m = pmesh.make_mesh()  # (dp=4, tp=2)
    step = pmesh.sharded_kron_apply(m)
    in_s, c_s = pmesh.shard_inputs(m, data["in_coa"], data["c_coa3"])
    out, norm = step(in_s, c_s)
    ref_norm = float(np.linalg.norm(bwdtrans.reference3d(data["basis"], 512)))
    assert float(norm) == pytest.approx(ref_norm, rel=1e-10)
    single = np.asarray(data["c_coa3"]) @ np.asarray(data["in_coa"])
    np.testing.assert_allclose(np.asarray(out), single, rtol=1e-10)


def test_sharded_pallas_elementwise(data, cfg64):
    from gpu_bench.kernels import bwdtrans as pl_bt

    m = pmesh.make_mesh(tp=1)  # pure dp over 8 devices
    fn = functools.partial(pl_bt.sum_factorization, te=16, interpret=True)
    args = (data["in_coa"], data["b0"], data["b1"], data["b2"])
    step = pmesh.sharded_elementwise_apply(m, fn)(*args)
    out, norm_sq = step(*args)
    ref_norm = float(np.linalg.norm(bwdtrans.reference3d(data["basis"], 512)))
    assert float(np.sqrt(norm_sq[0])) == pytest.approx(ref_norm, rel=1e-10)


def test_stream_dp_8dev(cfg32):
    """dp streaming benchmarks (b01 reduce / b02 add) over the virtual mesh:
    global norms must match the single-stream formulas."""
    from gpu_bench.core.reporting import Reporter
    from gpu_bench.ops import initdata
    from gpu_bench.parallel import benchmark_stream

    lines = []
    rep = Reporter.__new__(Reporter)
    rep.stream = None
    rep.note = lines.append
    rep.emit = lambda *a: lines.append(a)

    benchmark_stream.run01(1024, cfg32, rep)
    _, size, _, norms, values, _ = lines[-1]
    x = np.asarray(initdata.device_x(size, cfg32.dtype))
    assert norms[0] == pytest.approx(float(np.linalg.norm(x)), rel=1e-5)
    assert values[0] > 0

    benchmark_stream.run02(1024, cfg32, rep)
    _, size, _, norms, values, _ = lines[-1]
    x = np.asarray(initdata.device_x(size, cfg32.dtype))
    y = np.asarray(initdata.device_y(size, cfg32.dtype))
    assert norms[0] == pytest.approx(float(np.linalg.norm(x + y)), rel=1e-5)


def test_benchmark_dp_8dev(cfg32):
    """Weak-scaling dp driver over the 8-device virtual mesh: runs, scales
    the element count by the device count, and validates the global norm."""
    import numpy as np

    from gpu_bench.core.reporting import Reporter
    from gpu_bench.ops import bwdtrans
    from gpu_bench.parallel import benchmark_dp

    lines = []
    rep = Reporter.__new__(Reporter)
    rep.stream = None
    rep.note = lines.append
    rep.emit = lambda *a: lines.append(a)

    gdofs = benchmark_dp.run(4, 64, cfg32, rep)
    assert gdofs > 0
    prefix, nelmt, labels, norms, values, unit = lines[-1]
    # the per-device slab is rounded up to 128 elements so e_pad stays
    # divisible by 128 * n_dev for any device count
    assert nelmt == 128 * 8
    want = float(np.linalg.norm(bwdtrans.reference3d(
        bwdtrans.make_basis3d(4, 4, 4, cfg32.dtype), nelmt)))
    assert norms[0] == pytest.approx(want, rel=1e-4)
    assert labels == ["dp8x128"]
