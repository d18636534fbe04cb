"""Benchmark 02 — streaming vector addition x += y (STREAM-add-like).

Reference: benchmark02/benchmark02.cc (harness :73-260, sweep like b01).
GB/s counts 2 reads + 1 write: 3*sizeof(T)*1e-9*size/t
(:255-259).  NOTE the reference's validation norm is computed AFTER the 40
timed repetitions, i.e. it is ||x0 + 40*y|| (:161-164) — the validation pass
here applies exactly cfg.n_tests accumulating additions to a fresh x so the
printed norms stay comparable with the committed reference logs.

x += y chains naturally (each rep reads the previous x), so chained timing
needs no optimization_barrier: the fori_loop body IS the steady-state kernel.

Variant mapping:
  Kokkos parallel_for   -> XLA add with x donated (true in-place)
  thrust::transform     -> XLA functional add
The reference's hand-CUDA adds (scalar, float4/double2, functor) have no
column: an in-place Triton add did not beat XLA(donate) at f32 on the H100
(PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_bench.baselines import axpy as xla_axpy
from gpu_bench.core import variants
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.timing import Timer, resolve_mode, time_chained
from gpu_bench.core.validate import (check_norm_agreement, default_rtol,
                                     fail_soft, l2norm)
from gpu_bench.ops import initdata


LABELS = ["XLA(donate)", "XLA"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys) — core/variants.py convention.
    The "x" key is a lazy derived entry (fresh per access): the donated
    in-place variant consumes its input, so each timing/validation pass
    needs its own copy."""
    del data, cfg
    return [
        ("XLA(donate)", xla_axpy.add_donated, ("x", "y")),
        ("XLA", xla_axpy.add, ("x", "y")),
    ]


def build_variants(data, cfg):
    return variants.materialize(variant_specs(data, cfg), data)


def _accum_chain(fn):
    """run_k(k, x, y): k accumulating in-place additions, scalar probe out."""

    @jax.jit
    def run_k(k, x, y):
        out = jax.lax.fori_loop(0, k, lambda i, xx: fn(xx, y), x)
        # sum (not a single element) so XLA cannot slice-propagate the
        # probe through the loop and elide the streaming work
        return jnp.sum(out.astype(jnp.float32))

    return run_k


def _accum_apply(fn):
    """apply_n(k, x, y): k accumulating additions, returns the final x."""

    @jax.jit
    def apply_n(k, x, y):
        return jax.lax.fori_loop(0, k, lambda i, xx: fn(xx, y), x)

    return apply_n


def _time_accumulating(fn, cfg, data, xkey="x", ykey="y"):
    """Time one x += y application; return (seconds, x_after_n_tests_reps).
    data[xkey] yields a FRESH x per access (lazy derived layout)."""
    y = data[ykey]
    if resolve_mode(cfg) == "chained":
        run_k = _accum_chain(fn)
        t, _ = time_chained(run_k, (data[xkey], y), n_tests=cfg.n_tests)
        x_final = _accum_apply(fn)(jnp.int32(cfg.n_tests), data[xkey], y)
        return t, x_final

    # dispatch mode: warm the jit cache on a scratch x (donation may
    # invalidate it), then exactly n_tests timed accumulating reps.
    jax.block_until_ready(fn(data[xkey], y))
    x = data[xkey]
    jax.block_until_ready(x)
    timer = Timer()
    best = float("inf")
    for _ in range(cfg.n_tests):
        timer.start()
        x = fn(x, y)
        jax.block_until_ready(x)
        timer.stop()
        best = min(best, timer.elapsed_seconds())
    return best, x


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    y = initdata.device_y(size, cfg.dtype)
    jax.block_until_ready(y)
    data = variants.Layouts(
        base={"y": y},
        derived={"x": lambda: initdata.device_x(size, cfg.dtype)})

    def timed(fn, keys):
        def thunk():
            t, x_final = _time_accumulating(fn, cfg, data, *keys)
            norm = l2norm(x_final)
            del x_final
            return t, norm
        return thunk

    times, norms = [], []
    for label, fn, keys in variant_specs(data, cfg):
        t, norm = fail_soft(label, reporter, timed(fn, keys))
        times.append(t)
        norms.append(norm)

    if cfg.validate:
        for msg in check_norm_agreement(LABELS, norms, default_rtol(cfg.dtype),
                                        context=f"b02 size={size}"):
            reporter.warn(msg)

    gbs = [3 * cfg.itemsize * 1e-9 * size / t for t in times]
    reporter.emit("Size", size, LABELS, norms, gbs, "GB/s")


def main(argv=None):
    from gpu_bench.benchmarks import cli

    args = cli.build_parser("benchmark02").parse_args(argv)
    cfg = Config.from_flags(args)
    reporter = Reporter("Benchmark02 : Vector Addition")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(1024, 536870912, args):
            if 4 * size * cfg.itemsize > cap:  # y + x + warmup scratch + slack
                reporter.note(f"b02: stopping sweep at size {size} (memory cap)")
                break
            cli.guarded(reporter, "b02", size, run_test, size, cfg, reporter)
    cli.finish(reporter)


if __name__ == "__main__":
    main()
