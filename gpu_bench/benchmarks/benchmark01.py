"""Benchmark 01 — L2-norm reduction sqrt(sum x_i^2).

Reference: benchmark01/benchmark01.cc (harness :183-335, sweep :343).
GB/s counts 1x read traffic: sizeof(T)*1e-9*size/t (:330-334).
Sweep: size = 1024 .. 536870912 (x2).  Norm printed is sqrt(sum x^2).

Variant mapping (reference tier -> this suite):
  Kokkos parallel_reduce      -> XLA jnp.sum(x*x)
  thrust::transform_reduce    -> XLA self-dot contraction
The reference's hand-CUDA reductions (two-pass partials, vector loads,
functor) have no column: a two-pass Triton reduction in their design did
not beat XLA's reduction fusion on the H100 (PERF.md).
"""

from __future__ import annotations

import math

import jax

from gpu_bench.baselines import reduction as xla_red
from gpu_bench.core import variants
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.validate import (check_norm_agreement, default_rtol,
                                     measure_checked)
from gpu_bench.ops import initdata

import jax.numpy as jnp


def _chain(fn):
    """Chained-timing step: thread the probe through the eps scalar, which
    every b01 variant folds into its transform at zero memory cost."""

    def chain_fn(p, x):
        return fn(x, jnp.float32(0.0) * p)

    return chain_fn

LABELS = ["XLA", "XLA(dot)"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys) — core/variants.py convention.
    One streaming operand; the chained probe threads through the eps
    scalar every b01 variant folds in (_chain), not an operand key."""
    del data, cfg
    return [
        ("XLA", xla_red.sumsq, ("x",)),
        ("XLA(dot)", xla_red.sumsq_dot, ("x",)),
    ]


def build_variants(data, cfg):
    return variants.materialize(variant_specs(data, cfg), data)


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    """Time every variant at one size and emit the log-line triple
    (the run_test<T> analog, benchmark01/benchmark01.cc:183-335)."""
    x = initdata.device_x(size, cfg.dtype)
    jax.block_until_ready(x)
    data = {"x": x}

    times, norms = [], []
    for label, fn, keys in variant_specs(data, cfg):
        args = tuple(data[k] for k in keys)
        # b01's kernel output is the sumsq scalar itself, so its norm is
        # sqrt(out) = witness ** 0.25 (the witness squares the output)
        t, norm = measure_checked(
            label, fn, args, cfg, reporter, chain_fn=_chain(fn),
            norm_fn=lambda out: math.sqrt(float(out)),
            witness_norm=lambda w: w ** 0.25)
        times.append(t)
        norms.append(norm)

    if cfg.validate:
        for msg in check_norm_agreement(LABELS, norms, default_rtol(cfg.dtype),
                                        context=f"b01 size={size}"):
            reporter.warn(msg)

    gbs = [cfg.itemsize * 1e-9 * size / t for t in times]
    reporter.emit("Size", size, LABELS, norms, gbs, "GB/s")


def main(argv=None):
    from gpu_bench.benchmarks import cli

    args = cli.build_parser("benchmark01").parse_args(argv)
    cfg = Config.from_flags(args)
    reporter = Reporter("Benchmark01 : L2 norm reduction")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(1024, 536870912, args):
            if size * cfg.itemsize > cap:
                reporter.note(f"b01: stopping sweep at size {size} (memory cap)")
                break
            cli.guarded(reporter, "b01", size, run_test, size, cfg, reporter)
    cli.finish(reporter)


if __name__ == "__main__":
    main()
