"""Multi-device element-parallel BwdTrans benchmark (additive; the reference
is single-GPU by design, SURVEY.md §2.3/§5.8).

Runs the fused 3D sum-factorization kernel data-parallel over every
available device: elements sharded on the dp mesh axis via shard_map, a
psum-reduced global validation norm, and aggregate GDOF/s reported.  On
several GPUs this is the weak-scaling element sweep; on one it reduces to
benchmark05's Pallas(QP/Shared) column; in the test suite it runs on 8
virtual CPU devices in interpret mode.

Usage:  python -m gpu_bench.parallel.benchmark_dp [nq] [nelmt_per_device]
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.timing import eps_chain, measure
from gpu_bench.benchmarks import benchmark05 as b05
from gpu_bench.kernels import bwdtrans as pl_bt
from gpu_bench.ops import initdata
from gpu_bench.parallel import mesh as pmesh


def build_step(mesh, data, cfg):
    """(validated, timed) jitted steps (in_coa, b0, b1, b2) -> out over a
    pure-dp mesh: each device runs the fused kernel on its element slab;
    the validated step also returns the psum-reduced norm_sq[1]."""
    fn = functools.partial(pl_bt.sum_factorization, te=data["te"],
                           interpret=cfg.interpret)
    args = (data["in_coa"], data["b0"], data["b1"], data["b2"])
    make = pmesh.sharded_elementwise_apply(mesh, fn)
    make_fast = pmesh.sharded_elementwise_apply(mesh, fn, with_norm=False)
    return make(*args), make_fast(*args)


def run(nq: int, nelmt_per_dev: int, cfg: Config,
        reporter: Reporter, devices=None) -> float:
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    # each device's element slab keeps the 128-element padding granule,
    # so e_pad stays divisible by 128 * dp for any device count
    nelmt_per_dev = initdata.round_up(nelmt_per_dev, 128)
    nelmt = nelmt_per_dev * n_dev
    data = b05.prepare(nq, nq, nq, nelmt, cfg)
    mesh = pmesh.make_mesh(devices, tp=1)
    step, step_fast = build_step(mesh, data, cfg)
    args = (data["in_coa"], data["b0"], data["b1"], data["b2"])
    jax.block_until_ready(args[0])

    out, norm_sq = step(*args)  # validation pass: psum-reduced global norm
    norm = float(jnp.sqrt(norm_sq[0]))
    del out
    # timed step excludes the validation norm (an extra full output read)
    t = measure(step_fast, args, cfg,
                chain_fn=eps_chain(step_fast, eps_arg=1))
    nm = (nq - 1) ** 3
    gdofs = 1e-9 * nelmt * nm / t
    reporter.emit("nelmt", nelmt, [f"dp{n_dev}x{nelmt_per_dev}"], [norm],
                  [gdofs], "DOF/s")
    return gdofs


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="benchmark_dp")
    p.add_argument("nq", nargs="?", type=int, default=8)
    p.add_argument("nelmt_per_dev", nargs="?", type=int, default=131072)
    p.add_argument("--ntests", type=int, default=16)
    args = p.parse_args(argv)
    cfg = Config(n_tests=args.ntests)
    n = len(jax.devices())
    reporter = Reporter(f"Benchmark DP : BwdTrans (3D) over {n} device(s)")
    reporter.sweep_title(f"BwdTrans (NQ = {args.nq}) x {n} devices")
    run(args.nq, args.nelmt_per_dev, cfg, reporter)


if __name__ == "__main__":
    main()
