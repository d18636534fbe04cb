"""Benchmark 03 — dense matrix-vector multiply y = A.x.

Reference: benchmark03/benchmark03.cc (harness :106-350).
GB/s counts the matrix traffic only: sizeof(T)*1e-9*M*N/t (:331-336).
Sweep: M = N = 128 .. 16384 (x2, `2<<6 .. <2<<14`, :345).
Data: A[i,j] = sin(i*N+j+1), x[j] = j (:161-167).

Variant mapping:
  Kokkos TeamPolicy row-reduce -> XLA broadcast-multiply + row sum
  cuBLAS gemv 'T' (row-major)  -> XLA dot_general on row-major A
  cuBLAS gemv 'N' (col-major)  -> XLA dot_general on transposed copy
The reference's hand-CUDA block-per-row dots have no column: a Triton
row-block GEMV in that design did not beat XLA(gemv-rm) on the H100
(PERF.md).

Chained timing perturbs x (tiny next to A's streaming traffic).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpu_bench.baselines import matvec as xla_mv
from gpu_bench.core import variants
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.timing import eps_chain
from gpu_bench.core.validate import (check_norm_agreement, default_rtol,
                                     measure_checked)
from gpu_bench.ops import initdata

LABELS = ["XLA(rowsum)", "XLA(gemv-rm)", "XLA(gemv-cm)"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys) — core/variants.py convention.
    The matrix key picks the layout ("a_rm" row-major / "a_cm" the
    column-major copy); index 1 ("x") is the small operand the chained
    timer perturbs (eps_chain)."""
    del data
    return [
        ("XLA(rowsum)", xla_mv.rowsum, ("a_rm", "x")),
        ("XLA(gemv-rm)",
         functools.partial(xla_mv.gemv_rm, precision=cfg.dot_precision),
         ("a_rm", "x")),
        ("XLA(gemv-cm)",
         functools.partial(xla_mv.gemv_cm, precision=cfg.dot_precision),
         ("a_cm", "x")),
    ]


def build_variants(data, cfg):
    return variants.materialize(variant_specs(data, cfg), data)


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    m = n = size
    a = initdata.host_matrix_sin1((m, n), cfg.dtype)
    a_t = jnp.asarray(a.T)  # column-major copy, materialized untimed
    x = initdata.host_x_linear(n, cfg.dtype)
    jax.block_until_ready((a, a_t, x))
    data = {"a_rm": a, "a_cm": a_t, "x": x}

    times, norms = [], []
    for label, fn, keys in variant_specs(data, cfg):
        args = tuple(data[k] for k in keys)
        t, norm = measure_checked(label, fn, args, cfg, reporter,
                                  chain_fn=eps_chain(fn, eps_arg=1))
        times.append(t)
        norms.append(norm)

    if cfg.validate:
        for msg in check_norm_agreement(LABELS, norms, default_rtol(cfg.dtype),
                                        context=f"b03 size={size}"):
            reporter.warn(msg)

    gbs = [cfg.itemsize * 1e-9 * m * n / t for t in times]
    reporter.emit("Size", size, LABELS, norms, gbs, "GB/s")


def main(argv=None):
    from gpu_bench.benchmarks import cli

    args = cli.build_parser("benchmark03").parse_args(argv)
    cfg = Config.from_flags(args)
    reporter = Reporter("Benchmark03 : Matrix-Vector Mult")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(128, 16384, args):
            if 3 * size * size * cfg.itemsize > cap:  # A + A^T + slack
                reporter.note(f"b03: stopping sweep at size {size} (memory cap)")
                break
            cli.guarded(reporter, "b03", size, run_test, size, cfg, reporter)
    cli.finish(reporter)


if __name__ == "__main__":
    main()
