"""Benchmark 05 — 3D tensor-product sum-factorization (BwdTrans hex).

Reference: benchmark05/benchmark05.cc (harness :619-1421, CLI :1423-1442:
`nq0 nq1 nq2 threads elblocks`).  GDOF/s counts input DOFs:
1e-9*nelmt*nm0*nm1*nm2/t (:1407-1419).  Sweep: nelmt = 128 .. 1,048,576.

Variant mapping (reference -> this suite), as in benchmark04 with a third
contraction stage:
  Kokkos Uncoalesced / Coalesced -> XLA einsum, element-major / -minor
  Kokkos QP / QP+scratch         -> XLA staged einsum / dot_general
  cuBLAS gemm+gemmStridedBatched -> XLA single kron-operator GEMM
  Cuda QP/Shared                 -> Pallas fused sum-factorization
                                    (kernels/bwdtrans.py, Triton route)
The reference's other hand kernels (uncoalesced, coalesced, QP with global
workspaces, QP-1D) compute what the XLA columns already compute.
"""

from __future__ import annotations

import jax

from gpu_bench.baselines import bwdtrans3d as xla_bt
from gpu_bench.core import variants
from gpu_bench.core.config import Config
from gpu_bench.core.reporting import Reporter
from gpu_bench.benchmarks import benchmark04 as b04_mod
from gpu_bench.core.validate import check_norm_agreement, default_rtol
from gpu_bench.ops import bwdtrans, initdata


LABELS = [
    "XLA(Uncoales)", "XLA(Coales)", "XLA(QP)", "XLA(QP/DG)", "XLA(GEMM)",
    "Pallas(QP/Shared)",
]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys); the key at index 1 is the small
    perturbed operand.  Keys resolve lazily (ops.bwdtrans.Layouts)."""
    ce = data["xla_ce"] if "xla_ce" in data else None
    _xla = b04_mod.xla_column
    return [
        ("XLA(Uncoales)", _xla(xla_bt.einsum_em, cfg, ce),
         ("in_em4", "b0", "b1", "b2")),
        ("XLA(Coales)", _xla(xla_bt.einsum_coa, cfg, ce, axis=-1),
         ("in_coa4", "b0", "b1", "b2")),
        ("XLA(QP)", _xla(xla_bt.staged_em, cfg, ce),
         ("in_em4", "b0", "b1", "b2")),
        ("XLA(QP/DG)", _xla(xla_bt.staged_dotgeneral, cfg, ce),
         ("in_em4", "b0", "b1", "b2")),
        ("XLA(GEMM)", _xla(xla_bt.gemm_kron, cfg, ce, axis=-1),
         ("in_coa", "c_coa3")),
        ("Pallas(QP/Shared)", b04_mod.fused(data, cfg),
         ("in_coa", "b0", "b1", "b2")),
    ]


def build_variants(data, cfg):
    """(label, fn, args) with every operand materialized — test-suite and
    small-size convenience; sweeps use variant_specs + lazy resolution."""
    return variants.materialize(variant_specs(data, cfg), data)


def prepare(nq0: int, nq1: int, nq2: int, nelmt: int, cfg: Config) -> dict:
    basis = bwdtrans.make_basis3d(nq0, nq1, nq2, cfg.dtype)
    e_pad = initdata.round_up(nelmt, 128)
    src = bwdtrans.stream_sources(
        bwdtrans.element_data3d(basis, cfg.dtype),
        (basis.nm2, basis.nm1, basis.nm0), nelmt, e_pad, cfg.dtype)
    c_em3 = bwdtrans.operator3d(basis)
    nm0, nm1, nm2 = basis.nm0, basis.nm1, basis.nm2
    nm_tot, nq_tot = basis.nm_tot, basis.nq_tot
    data = bwdtrans.Layouts(
        base=dict(
            basis=basis,
            nelmt=nelmt,
            e_pad=e_pad,
            b0=basis.b0, b1=basis.b1, b2=basis.b2,
            c_coa3=jax.numpy.asarray(c_em3.T),
        ),
        # ALL layouts of the element stream are lazy, built fresh straight
        # from the coefficient vector (stream_sources): one layout resident
        # at a time
        derived=dict(
            in_em2=src["em2"],
            in_coa=src["coa"],
            in_em4=lambda: src["em2"]().reshape(e_pad, nm2, nm1, nm0),
            in_coa4=lambda: src["coa"]().reshape(nm2, nm1, nm0, e_pad),
        ),
    )
    # XLA-tier element chunking (see benchmark04.prepare): bound the staged
    # variants' workspace residency at the largest sweep sizes
    w_cols = max(nm2 * nm1 * nq0, nm2 * nq1 * nq0)
    data["xla_ce"] = bwdtrans.choose_xla_chunk(
        (nm_tot + 2 * nq_tot) * e_pad * cfg.itemsize, w_cols * cfg.itemsize,
        e_pad, cfg.mem_cap_bytes)
    data["te"] = b04_mod.element_tile(
        data, cfg, f"nq{nq0}x{nq1}x{nq2}", ("in_coa", "b0", "b1", "b2"))
    return data


def run_test(nelmt: int, nq0: int, nq1: int, nq2: int, cfg: Config,
             reporter: Reporter) -> None:
    data = prepare(nq0, nq1, nq2, nelmt, cfg)
    jax.block_until_ready(data["b0"])
    times, norms = b04_mod.measure_all(variant_specs(data, cfg), data, cfg,
                                       reporter)
    if cfg.validate:
        for msg in check_norm_agreement(LABELS, norms, default_rtol(cfg.dtype),
                                        context=f"b05 nelmt={nelmt}"):
            reporter.warn(msg)

    nm = (nq0 - 1) * (nq1 - 1) * (nq2 - 1)
    dofs = [1e-9 * nelmt * nm / t for t in times]
    reporter.emit("nelmt", nelmt, LABELS, norms, dofs, "DOF/s")


def main(argv=None):
    from gpu_bench.benchmarks import cli

    parser = cli.build_parser(
        "benchmark05",
        positionals=[("nq0", 8), ("nq1", 8), ("nq2", 8), ("threads", None),
                     ("elblocks", None)],
    )
    args = parser.parse_args(argv)
    cfg = Config.from_flags(args)
    if cfg.epb is None and args.threads and args.elblocks:
        cfg.epb = args.threads * args.elblocks
    nq0, nq1, nq2 = args.nq0, args.nq1, args.nq2
    nm_tot = (nq0 - 1) * (nq1 - 1) * (nq2 - 1)
    nq_tot = nq0 * nq1 * nq2
    reporter = Reporter("Benchmark05 : BwdTrans (3D)")
    reporter.sweep_title(f"BwdTrans (NQ = {nq0}, {nq1}, {nq2})")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for nelmt in cli.sweep(128, 1048576, args):
            # residency model mirrors benchmark04.main: one lazy input
            # layout + two outputs + two in-flight 64Ki-element XLA
            # workspace chunks
            wsp = max((nq2 - 1) * (nq1 - 1) * nq0, (nq2 - 1) * nq1 * nq0)
            need = ((nm_tot + 2 * nq_tot) * nelmt
                    + 2 * wsp * 65536) * cfg.itemsize
            if need > cap:
                reporter.note(f"b05: stopping sweep at nelmt {nelmt} (memory cap)")
                break
            cli.guarded(reporter, "b05", nelmt, run_test, nelmt, nq0, nq1, nq2, cfg, reporter)
    cli.finish(reporter)


if __name__ == "__main__":
    main()
