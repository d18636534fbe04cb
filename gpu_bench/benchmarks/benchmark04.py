"""Benchmark 04 — 2D tensor-product sum-factorization (BwdTrans quad).

Reference: benchmark04/benchmark04.cc (harness :428-1056, CLI :1058-1075).
GDOF/s counts input DOFs: 1e-9*nelmt*nm0*nm1/t (:1043-1054).
Sweep: nelmt = 128 .. 1,048,576 (x2, :1070); nq from argv (default 8 8).

Variant mapping (reference -> this suite, SURVEY.md §7):
  Kokkos Uncoalesced        -> XLA einsum, element-major layout
  Kokkos Coalesced          -> XLA einsum, element-minor layout
  Kokkos QP                 -> XLA explicit two-stage einsum (HBM wsp)
  Kokkos QP/Shared          -> XLA two-stage dot_general
  cuBLAS gemm+gemmBatched   -> XLA single kron-operator GEMM
  Cuda QP/Shared            -> Pallas fused sum-factorization, one Triton
                               program per element tile (kernels/bwdtrans.py)
The reference's other CUDA kernels (uncoalesced, coalesced, QP with global
workspace, QP-1D) are the dense kron GEMM or the staged contractions that
the XLA columns already run through cuBLAS and XLA's own fusions.

`epb` is the threads/elblocks analog (reference defaults 128 1,
:1060-1063): the fused kernel's element tile.  Chained timing perturbs the
basis/operator matrices (tiny next to the element streams).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpu_bench.baselines import bwdtrans2d as xla_bt
from gpu_bench.core import variants
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.timing import eps_chain
from gpu_bench.core.validate import (check_norm_agreement, default_rtol,
                                     measure_checked)
from gpu_bench.kernels import bwdtrans as pl_bt
from gpu_bench.ops import bwdtrans, initdata


def xla_column(fn, cfg, ce=None, axis=0):
    """An XLA column: fn at the config's dot precision, chunked over ce
    elements along `axis` when a workspace would not fit (shared with
    benchmark05)."""
    if ce:
        fn = xla_bt.chunk_elems(fn, ce, axis)
    return functools.partial(fn, precision=cfg.dot_precision)


def fused(data, cfg, te=None):
    """The Pallas(QP/Shared) column: jitted sum_factorization(in_coa,
    *bases) at the element tile data["te"] (shared with benchmark05)."""
    return jax.jit(functools.partial(
        pl_bt.sum_factorization, te=te or data["te"],
        interpret=cfg.interpret))


def element_tile(data, cfg, sig, keys):
    """The fused kernel's element tile: --epb when given, the autotuned
    tile under --autotune, else None (the kernel's 128-byte row tile)."""
    if not cfg.autotune or cfg.epb is not None:
        return cfg.epb
    from gpu_bench.core import autotune as at

    args = tuple(data[k] for k in keys)
    return at.autotune_epb(
        f"b0{len(keys) + 2}/qp_shared", sig,
        lambda te: (fused(data, cfg, te), args), cfg, data["e_pad"],
        candidates=(16, 32, 64, 128))


def measure_all(specs, data, cfg, reporter):
    """(times, norms) of every variant, operands resolved one variant at a
    time (shared by benchmarks 04/05).  Pallas outputs are opaque to XLA,
    so the Pallas column may carry only the probe scalar through a timing
    chain (timing.build_chain)."""
    times, norms = [], []
    for label, fn, keys in specs:
        args = tuple(data[k] for k in keys)  # lazy derived layouts
        t, norm = measure_checked(
            label, fn, args, cfg, reporter, chain_fn=eps_chain(fn, eps_arg=1),
            carry="scalar" if label.startswith("Pallas") else "array")
        del args
        times.append(t)
        norms.append(norm)
    return times, norms


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys) for the variant table; the key
    at index 1 names the small operand the chained timer perturbs.  Keys
    resolve through ops.bwdtrans.Layouts, so derived layouts of the element
    stream materialize one variant at a time."""
    ce = data["xla_ce"] if "xla_ce" in data else None
    _xla = xla_column
    return [
        ("XLA(Uncoales)", _xla(xla_bt.einsum_em, cfg, ce),
         ("in_em3", "b0", "b1")),
        ("XLA(Coales)", _xla(xla_bt.einsum_coa, cfg, ce, axis=-1),
         ("in_coa3", "b0", "b1")),
        ("XLA(QP)", _xla(xla_bt.staged_em, cfg, ce), ("in_em3", "b0", "b1")),
        ("XLA(QP/DG)", _xla(xla_bt.staged_dotgeneral, cfg, ce),
         ("in_em3", "b0", "b1")),
        ("XLA(GEMM)", _xla(xla_bt.gemm_kron, cfg, ce, axis=-1),
         ("in_coa", "c_coa")),
        ("Pallas(QP/Shared)", fused(data, cfg), ("in_coa", "b0", "b1")),
    ]


def build_variants(data, cfg):
    """(label, fn, args) with every operand materialized — test-suite and
    small-size convenience; sweeps use variant_specs + lazy resolution."""
    return variants.materialize(variant_specs(data, cfg), data)


LABELS = [
    "XLA(Uncoales)", "XLA(Coales)", "XLA(QP)", "XLA(QP/DG)", "XLA(GEMM)",
    "Pallas(QP/Shared)",
]


def prepare(nq0: int, nq1: int, nelmt: int, cfg: Config) -> dict:
    basis = bwdtrans.make_basis2d(nq0, nq1, cfg.dtype)
    e_pad = initdata.round_up(nelmt, 128)
    src = bwdtrans.stream_sources(bwdtrans.element_data2d(basis, cfg.dtype),
                                  (basis.nm1, basis.nm0), nelmt, e_pad,
                                  cfg.dtype)
    c_em = bwdtrans.operator2d(basis)
    nm1, nm0 = basis.nm1, basis.nm0
    data = bwdtrans.Layouts(
        base=dict(
            basis=basis,
            nelmt=nelmt,
            e_pad=e_pad,
            b0=basis.b0,
            b1=basis.b1,
            c_coa=jnp.asarray(c_em.T),
        ),
        # ALL layouts of the element stream are lazy, built fresh straight
        # from the coefficient vector (stream_sources): one layout resident
        # at a time
        derived=dict(
            in_em2=src["em2"],
            in_coa=src["coa"],
            in_em3=lambda: src["em2"]().reshape(e_pad, nm1, nm0),
            in_coa3=lambda: src["coa"]().reshape(nm1, nm0, e_pad),
        ),
    )
    # XLA-tier element chunking: cap the staged variants' HBM workspace
    # residency once in + workspace + two chain-carried outputs would not
    # fit the sweep cap
    it = cfg.itemsize
    data["xla_ce"] = bwdtrans.choose_xla_chunk(
        (basis.nm_tot + 2 * basis.nq_tot) * e_pad * it, nm1 * nq0 * it,
        e_pad, cfg.mem_cap_bytes)
    data["te"] = element_tile(data, cfg, f"nq{nq0}x{nq1}",
                              ("in_coa", "b0", "b1"))
    return data


def run_test(nelmt: int, nq0: int, nq1: int, cfg: Config,
             reporter: Reporter) -> None:
    data = prepare(nq0, nq1, nelmt, cfg)
    jax.block_until_ready(data["b0"])
    times, norms = measure_all(variant_specs(data, cfg), data, cfg, reporter)
    if cfg.validate:
        for msg in check_norm_agreement(LABELS, norms, default_rtol(cfg.dtype),
                                        context=f"b04 nelmt={nelmt}"):
            reporter.warn(msg)

    nm0, nm1 = nq0 - 1, nq1 - 1
    dofs = [1e-9 * nelmt * nm0 * nm1 / t for t in times]
    reporter.emit("nelmt", nelmt, LABELS, norms, dofs, "DOF/s")


def main(argv=None):
    from gpu_bench.benchmarks import cli

    parser = cli.build_parser(
        "benchmark04",
        positionals=[("nq0", 8), ("nq1", 8), ("threads", None),
                     ("elblocks", None)],
    )
    args = parser.parse_args(argv)
    cfg = Config.from_flags(args)
    if cfg.epb is None and args.threads and args.elblocks:
        cfg.epb = args.threads * args.elblocks
    nq0, nq1 = args.nq0, args.nq1
    nm0, nm1 = nq0 - 1, nq1 - 1
    reporter = Reporter("Benchmark04 : BwdTrans (2D)")
    reporter.sweep_title(f"BwdTrans (NQ = {nq0}, {nq1})")
    cap = cfg.mem_cap_bytes
    nm_tot, nq_tot = nm0 * nm1, nq0 * nq1
    with cli.profiled(args):
        for nelmt in cli.sweep(128, 1048576, args):
            # residency model: one lazily-built input layout + two
            # chain-carried outputs (XLA tiers, workspaces chunked by
            # choose_xla_chunk) + two in-flight 64Ki-element workspace
            # chunks
            wsp = nm1 * nq0
            need = ((nm_tot + 2 * nq_tot) * nelmt
                    + 2 * wsp * 65536) * cfg.itemsize
            if need > cap:
                reporter.note(f"b04: stopping sweep at nelmt {nelmt} (memory cap)")
                break
            cli.guarded(reporter, "b04", nelmt, run_test, nelmt, nq0, nq1, cfg, reporter)
    cli.finish(reporter)


if __name__ == "__main__":
    main()
