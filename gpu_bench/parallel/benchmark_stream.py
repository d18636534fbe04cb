"""Multi-device data-parallel streaming benchmarks (additive; the reference
is single-GPU by design, SURVEY.md §2.3/§5.8).

The dp analogs of benchmark01/benchmark02: the element stream sharded
across every device on a 1D dp mesh via shard_map,

  * b01: each device reduces its slab with benchmark01's XLA
    sum of squares; partials are psum-reduced — the cross-device analog
    of the reference's two-kernel partial reduction
    (benchmark01/benchmark01.cc:15-181);
  * b02: each device runs the streaming add on its slab; the validation
    norm is psum-reduced.

Aggregate GB/s is reported (per-device bandwidth x device count at perfect
weak scaling).

Usage:  python -m gpu_bench.parallel.benchmark_stream [b01|b02] [size_per_dev]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gpu_bench.baselines import axpy as xla_axpy
from gpu_bench.baselines import reduction as xla_red
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.timing import eps_chain, measure
from gpu_bench.ops import initdata
from gpu_bench.parallel import mesh as pmesh


def _dp_mesh(devices=None):
    return pmesh.make_mesh(devices, tp=1)


def build_reduce(mesh, cfg):
    """jitted (x,) -> global sum of squares over the dp-sharded stream."""
    del cfg

    def local_step(x_loc, eps):
        return jax.lax.psum(jnp.atleast_1d(xla_red.sumsq(x_loc, eps)),
                            ("dp", "tp"))

    mapped = jax.shard_map(local_step, mesh=mesh,
                           in_specs=(P(("dp", "tp")), P()),
                           out_specs=P(None), check_vma=False)
    return jax.jit(lambda x, eps: mapped(x, eps)[0])


def build_add(mesh, cfg):
    """jitted (x, y) -> x + y with both streams dp-sharded."""
    del cfg
    mapped = jax.shard_map(xla_axpy.add, mesh=mesh,
                           in_specs=(P(("dp", "tp")), P(("dp", "tp"))),
                           out_specs=P(("dp", "tp")), check_vma=False)
    return jax.jit(mapped)


def run01(size_per_dev: int, cfg: Config, reporter: Reporter,
          devices=None) -> float:
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    mesh = _dp_mesh(devices)
    size = initdata.round_up(size_per_dev, 1024) * n_dev
    x = initdata.device_x(size, cfg.dtype)
    x = jax.device_put(x, NamedSharding(mesh, P(("dp", "tp"))))
    fn = build_reduce(mesh, cfg)
    eps = jnp.zeros((), jnp.float32)
    norm = float(jnp.sqrt(fn(x, eps)))
    t = measure(fn, (x, eps), cfg,
                chain_fn=lambda p, xx, e: fn(xx, jnp.float32(0.0) * p))
    gbs = cfg.itemsize * 1e-9 * size / t
    reporter.emit("Size", size, [f"dp{n_dev}-reduce"], [norm], [gbs], "GB/s")
    return gbs


def run02(size_per_dev: int, cfg: Config, reporter: Reporter,
          devices=None) -> float:
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    mesh = _dp_mesh(devices)
    size = initdata.round_up(size_per_dev, 1024) * n_dev
    sharding = NamedSharding(mesh, P(("dp", "tp")))
    x = jax.device_put(initdata.device_x(size, cfg.dtype),
                       sharding)
    y = jax.device_put(initdata.device_y(size, cfg.dtype),
                       sharding)
    fn = build_add(mesh, cfg)
    from gpu_bench.core.validate import l2norm

    norm = l2norm(fn(x, y))
    t = measure(fn, (x, y), cfg, chain_fn=eps_chain(fn, eps_arg=1))
    gbs = 3 * cfg.itemsize * 1e-9 * size / t
    reporter.emit("Size", size, [f"dp{n_dev}-add"], [norm], [gbs], "GB/s")
    return gbs


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="benchmark_stream")
    p.add_argument("bench", nargs="?", choices=["b01", "b02"], default="b02")
    p.add_argument("size_per_dev", nargs="?", type=int, default=67108864)
    p.add_argument("--ntests", type=int, default=16)
    args = p.parse_args(argv)
    cfg = Config(n_tests=args.ntests)
    n = len(jax.devices())
    reporter = Reporter(f"Benchmark DP : streaming over {n} device(s)")
    if args.bench == "b01":
        run01(args.size_per_dev, cfg, reporter)
    else:
        run02(args.size_per_dev, cfg, reporter)


if __name__ == "__main__":
    main()
