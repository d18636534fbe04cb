"""Memory-ceiling probes (benchmarks/ceilings.py) + roofline math."""

import pytest

from gpu_bench.core import roofline


# ---- roofline derivations ------------------------------------------------


def test_mixed_bandwidth_limits():
    # equal directional rates -> the shared-bus mix saturates at that rate
    assert roofline.mixed_bandwidth(700.0, 700.0, 2, 1) == pytest.approx(700)
    # pure directions
    assert roofline.mixed_bandwidth(733.0, 643.0, 1, 0) == 733.0
    assert roofline.mixed_bandwidth(733.0, 643.0, 0, 1) == 643.0
    # shared-bus mixed is between the directional rates
    add = roofline.stream_add_ceiling(733.0, 643.0)
    assert 643.0 < add < 733.0
    # hand check: 3 / (2/733 + 1/643)
    assert add == pytest.approx(3 / (2 / 733.0 + 1 / 643.0))
    # full-duplex bound is always >= shared-bus
    add_d = roofline.stream_add_ceiling(733.0, 643.0, duplex=True)
    assert add_d == pytest.approx(3 / (2 / 733.0))
    assert add_d > add


def test_bwdtrans_ceiling_hand_check():
    # b05 nq=4 f32: 27 reads + 64 writes of 4 B per element, 27 DOF
    r_b, w_b = 27 * 4, 64 * 4
    bw = (r_b + w_b) / (r_b / 733.0 + w_b / 643.0)
    want = bw / ((r_b + w_b) / 27)
    got = roofline.bwdtrans_ceiling_gdofs(733.0, 643.0, 4, 3, 4)
    assert got == pytest.approx(want)
    # higher nq streams fewer bytes per DOF -> higher ceiling
    assert (roofline.bwdtrans_ceiling_gdofs(733, 643, 8, 3, 4)
            > roofline.bwdtrans_ceiling_gdofs(733, 643, 4, 3, 4))


def test_ceilings_derived_table():
    from gpu_bench.benchmarks import ceilings

    bw = {"read": 733.0, "write": 643.0}
    rows = ceilings.derived_table(bw)
    names = [r[0] for r in rows]
    assert any("b02" in n for n in names)
    assert sum("b04" in n for n in names) == 9
    assert sum("b05" in n for n in names) == 5
    for _, shared, duplex, _ in rows:
        assert 0 < shared <= duplex * (1 + 1e-12)


def test_measure_directions_runs():
    """Every probe compiles, chains and yields a positive rate (on the CPU
    this is a smoke test; rates are device metrics only on the GPU)."""
    from gpu_bench.benchmarks import ceilings

    bw = ceilings.measure_directions(1 << 12, n_tests=4)
    assert set(bw) == {"read", "write", "copy_2x", "scale_2x", "add_3x",
                       "triad_3x", "expand2", "expand4", "expand8"}
    assert all(v > 0 for v in bw.values())
    rows = ceilings.derived_table(bw)
    assert len(rows) == 3 + 9 + 5
