"""Machine bandwidth ceilings — the measured denominators for every
"percent of roofline" claim.

The reference's implicit baseline is the STREAM number of its GPU (b02's
2R+1W metric, benchmark02/benchmark02.cc:255-259).  Read and write
directions of device memory need not saturate at the same rate, so this
benchmark measures each direction and the canonical STREAM mixes directly,
with plain XLA programs:

    read     1R      sum(x)
    write    1W      fill(out)
    copy     1R+1W   out = x
    scale    1R+1W   x *= c          (in place)
    add      2R+1W   x += y          (in place — b02's op)
    triad    2R+1W   x += c*y        (in place)
    expandM  1R+MW   out[m] = x      (the write-heavy BwdTrans mixes)

Each is timed by the harness (core/timing.py) at a working set far above
the GPU's 50 MB L2.  Output: human-readable ceiling lines, a derived
per-benchmark physical-ceiling table (core/roofline.py), and one
machine-parseable JSON line.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp

from gpu_bench.core import roofline, timing


def _carry_chain(step):
    """run_k(k, x0, *rest): k serialized applications x <- step(x, *rest);
    returns a scalar witness so every element of the result stays live."""

    @jax.jit
    def run_k(k, x0, *rest):
        out = jax.lax.fori_loop(0, k, lambda i, x: step(x, *rest), x0)
        return jnp.sum(out.astype(jnp.float32))

    return run_k


def _measure(step, args, n_tests):
    t, _ = timing.time_chained(_carry_chain(step), args, n_tests=n_tests)
    return t


def measure_directions(n: int, n_tests: int = 12) -> dict:
    """Measured GB/s of actual bus traffic per direction/mix at n f32
    elements per buffer."""
    gb = 4 * n * 1e-9
    x = jnp.arange(n, dtype=jnp.float32) % 7
    y = jnp.ones((n,), jnp.float32)
    c = jnp.float32(1.0000001)
    tok = jnp.zeros((1,), jnp.float32)
    jax.block_until_ready((x, y))
    out = {}
    # the carried token is a one-element array: the step reads all of x
    out["read"] = gb / _measure(
        lambda t, xx: jnp.sum(xx + t[0] * 0.0, keepdims=True), (tok, x),
        n_tests)
    out["write"] = gb / _measure(
        lambda o: jnp.full_like(o, o[0] + 1.0), (x,), n_tests)
    out["copy_2x"] = 2 * gb / _measure(
        lambda o, xx: xx + o[0] * 0.0, (x, x + 1.0), n_tests)
    out["scale_2x"] = 2 * gb / _measure(lambda o: o * c, (x,), n_tests)
    out["add_3x"] = 3 * gb / _measure(lambda o, yy: o + yy, (x, y), n_tests)
    out["triad_3x"] = 3 * gb / _measure(
        lambda o, yy: o + c * yy, (x, y), n_tests)
    for m in (2, 4, 8):
        o0 = jnp.zeros((m, n), jnp.float32)
        out[f"expand{m}"] = (1 + m) * gb / _measure(
            lambda o, xx: jnp.broadcast_to(xx + o[0, 0] * 0.0, o.shape),
            (o0, x), n_tests)
        del o0
    return out


def derived_table(bw: dict, itemsize: int = 4) -> list:
    """(name, shared_bus, empirical, unit) rows from the measured
    directions: shared-bus = no read/write overlap (the analytic target),
    empirical = the probe-ladder interpolation for that benchmark's exact
    mix (roofline.empirical_mix_bandwidth;
    falls back to full-duplex when the expand probes are absent)."""
    r, w = bw["read"], bw["write"]

    def emp(rb, wb, duplex_fallback):
        v = roofline.empirical_mix_bandwidth(bw, rb, wb)
        return v if v is not None else duplex_fallback

    rows = [
        ("b01 L2-norm (1R)", r, r, "GB/s"),
        ("b02 add 2R+1W (3x)", roofline.stream_add_ceiling(r, w),
         emp(2, 1, roofline.stream_add_ceiling(r, w, duplex=True)), "GB/s"),
        ("b03 matvec (A-read)", roofline.matvec_ceiling_gbs(r),
         roofline.matvec_ceiling_gbs(r), "GB/s"),
    ]
    for dim, nqs in ((2, (2, 4, 6, 8, 10, 12, 14, 16, 32)),
                     (3, (2, 4, 6, 8, 10))):
        for nq in nqs:
            v = roofline.empirical_bwdtrans_gdofs(bw, nq, dim, itemsize)
            if v is None:
                v = roofline.bwdtrans_ceiling_gdofs(r, w, nq, dim, itemsize,
                                                    duplex=True)
            rows.append((
                f"b0{dim + 2} {dim}D nq={nq}",
                roofline.bwdtrans_ceiling_gdofs(r, w, nq, dim, itemsize),
                v, "GDOF/s"))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="measure device-memory directional/mix bandwidths")
    parser.add_argument("--size", type=int, default=128 * 2**20,
                        help="elements per f32 buffer (default 128Mi)")
    parser.add_argument("--ntests", type=int, default=12)
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    print("-" * 32)
    print(f"{'Ceilings : memory directions':<32}")
    print("-" * 32)
    print(f"device: {dev.device_kind}; buffer {4 * args.size / 2**20:.0f} "
          f"MiB f32; chained timing", flush=True)
    bw = measure_directions(args.size, args.ntests)
    for k, v in bw.items():
        print(f"Measured {k} GB/s: {v:.10g}", flush=True)
    print("Derived physical ceilings (core/roofline.py): "
          "shared-bus | empirical")
    for name, v, vd, unit in derived_table(bw):
        print(f"Ceiling {name} ({unit}): {v:.10g} | {vd:.10g}")
    print(json.dumps({"device": dev.device_kind, "f32_elems": args.size,
                      **{k: round(v, 1) for k, v in bw.items()}}))


if __name__ == "__main__":
    main()
