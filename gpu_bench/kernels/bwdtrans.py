"""Fused sum-factorization BwdTrans kernel — the Pallas(QP/Shared) column of
benchmarks 04 (2D) and 05 (3D).

Reference: the QP/Shared CUDA kernels (benchmark04/benchmark04.cc and
benchmark05/benchmark05.cc:291-429): a block of elements, threads over
quadrature points, the basis and every stage workspace in __shared__
memory, so each element's modes are read once and its quadrature values
written once.

Here one Triton program owns a tile of `te` elements (a power of two) of
the coalesced layout: in (nmTot, E) and out (nqTot, E), element index
minor, so every row access is one contiguous te-wide load or store.  The
contraction is the minimal sum factorization, with the first quadrature
axis i carried as the rows of a (nq0p, te) register tensor (nq0p = nq0
rounded up to a power of two, zero rows masked on store):

    w1[q]      = sum_p  B0[p, :] (x) in[(r, q, p), :]     stage 1 (outer products)
    w2[j]      = sum_q  B1[q, j] * w1[q]                  stage 2
    out[k, j]  = sum_r  B2[r, k] * w2[j]                  stage 3 (3D)

Stage 1 reads each input row exactly once, straight from device memory;
stages 2 and 3 are scalar-times-tensor FMAs.  The slowest mode axis (q in
2D, r in 3D) is a loop whose carry is the output accumulator; the rest is
unrolled.  Nothing is padded in device memory: tails of the element axis
are masked loads and stores, and the i axis pads with zero columns of B0.
All arithmetic is FMAs in the accumulator dtype (f32 for f32 and bf16,
f64 for f64), so `precision` does not apply to this kernel.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpu_bench.kernels import common

# 2D: 32-bit registers a thread's output accumulators may take
_REGS_2D = 80

# The fastest (te, num_warps) of four tiles around the formula below, per
# benchmark order (isotropic nq), measured on an H100 at the b04/b05 cells
# (PERF.md).  Keyed (dims, nq, 32-bit words per accumulator value).
_MEASURED = {
    (3, 2, 1): (64, 4), (3, 4, 1): (128, 4), (3, 6, 1): (32, 4),
    (3, 8, 1): (64, 8), (3, 10, 1): (16, 4),
    (3, 2, 2): (128, 8), (3, 4, 2): (64, 4), (3, 6, 2): (32, 4),
    (3, 8, 2): (32, 8), (3, 10, 2): (16, 4),
    (2, 2, 1): (128, 1), (2, 4, 1): (128, 2), (2, 6, 1): (64, 1),
    (2, 8, 1): (32, 1), (2, 10, 1): (32, 2), (2, 12, 1): (32, 2),
    (2, 14, 1): (32, 2), (2, 16, 1): (32, 4), (2, 32, 1): (8, 4),
    (2, 2, 2): (64, 1), (2, 4, 2): (64, 2), (2, 6, 2): (16, 1),
    (2, 8, 2): (32, 2), (2, 10, 2): (16, 2), (2, 12, 2): (16, 2),
    (2, 14, 2): (8, 2), (2, 16, 2): (8, 2), (2, 32, 2): (8, 8),
}


def element_tile(nq, itemsize: int, te=None):
    """(te, num_warps) for an element tile of the fused kernel.

    The measured best tile at the benchmark orders (_MEASURED); elsewhere a
    formula fitted to the same H100 measurements (PERF.md): each (nq0p, te)
    accumulator holds about 512 32-bit words (te = 512 / nq0p, f64 counting
    double), spread over the threads so that in 3D each thread holds two
    words of every accumulator, and in 2D (fewer, larger accumulators) all
    nq1 of them take about _REGS_2D registers.  A given te (--epb) is
    floored to a power of two and gets the formula's warps."""
    nq0p = pl.next_power_of_2(nq[0])
    words = max(itemsize, 4) // 4
    key = (len(nq), nq[0], words)
    if te is None and len(set(nq)) == 1 and key in _MEASURED:
        return _MEASURED[key]
    if te is None:
        te = min(max(512 // (nq0p * words), 8), 128)
    te = common.pow2_floor(te)
    per_acc = nq0p * te * words
    if len(nq) == 3:
        nw = per_acc // 64
    else:
        nw = pl.next_power_of_2(-(-(nq[1] + 2) * per_acc // (32 * _REGS_2D)))
    return te, min(max(nw, 1), 16)


def _load_row(x_ref, row, e0, te, emask, acc):
    """Input row `row`, elements e0 .. e0+te, as a (1, te) tensor."""
    return plgpu.load(x_ref.at[pl.ds(row, 1), pl.ds(e0, te)],
                      mask=emask[None, :], other=0).astype(acc)


def _stage1(x_ref, b0, row0, e0, te, emask, acc):
    """sum_p B0[p, :] (x) in[row0 + p, :] -> (nq0p, te)."""
    w1 = None
    for p, b in enumerate(b0):
        t = b * _load_row(x_ref, row0 + p, e0, te, emask, acc)
        w1 = t if w1 is None else w1 + t
    return w1


def _store_rows(o_ref, out, nq0, e0, te, emask):
    """out[g] (nq0p, te) -> rows g*nq0 .. g*nq0+nq0-1 of the output."""
    nq0p = out[0].shape[0]
    mask = (jnp.arange(nq0p) < nq0)[:, None] & emask[None, :]
    for g, v in enumerate(out):
        # a traced start: the padded rows of the last group run past the
        # array, which only masked stores (never a static slice) may do
        row0 = g * nq0 + 0 * pl.program_id(0)
        plgpu.store(o_ref.at[pl.ds(row0, nq0p), pl.ds(e0, te)],
                    v.astype(o_ref.dtype), mask=mask)


def _kernel2d(b0_ref, b1_ref, x_ref, o_ref, *, nm, nq, te, n_elem, acc):
    nm0, nm1 = nm
    nq0, nq1 = nq
    nq0p = b0_ref.shape[1]
    e0 = pl.program_id(0) * te
    emask = e0 + jnp.arange(te) < n_elem
    b0 = [b0_ref[p, :].astype(acc)[:, None] for p in range(nm0)]

    def body(q, out):
        w1 = _stage1(x_ref, b0, q * nm0, e0, te, emask, acc)
        return [out[j] + b1_ref[q, j].astype(acc) * w1 for j in range(nq1)]

    out = jax.lax.fori_loop(0, nm1, body,
                            [jnp.zeros((nq0p, te), acc)] * nq1)
    _store_rows(o_ref, out, nq0, e0, te, emask)


def _kernel3d(b0_ref, b1_ref, b2_ref, x_ref, o_ref, *, nm, nq, te, n_elem,
              acc):
    nm0, nm1, _ = nm
    nq0, nq1, nq2 = nq
    nq0p = b0_ref.shape[1]
    e0 = pl.program_id(0) * te
    emask = e0 + jnp.arange(te) < n_elem
    b0 = [b0_ref[p, :].astype(acc)[:, None] for p in range(nm0)]

    def body(r, out):
        w2 = [None] * nq1
        for q in range(nm1):
            w1 = _stage1(x_ref, b0, (r * nm1 + q) * nm0, e0, te, emask, acc)
            for j in range(nq1):
                t = b1_ref[q, j].astype(acc) * w1
                w2[j] = t if w2[j] is None else w2[j] + t
        return [out[k * nq1 + j] + b2_ref[r, k].astype(acc) * w2[j]
                for k in range(nq2) for j in range(nq1)]

    out = jax.lax.fori_loop(0, nm[2], body,
                            [jnp.zeros((nq0p, te), acc)] * (nq2 * nq1))
    _store_rows(o_ref, out, nq0, e0, te, emask)


def sum_factorization(in_coa, *bases, te=None, interpret=False):
    """BwdTrans of the coalesced element stream: (nmTot, E) -> (nqTot, E).

    bases = (b0, b1) in 2D or (b0, b1, b2) in 3D, each (nm_d, nq_d); input
    rows are (r, q, p) with p minor, output rows (k, j, i) with i minor —
    the layout of XLA(GEMM)'s kron operator product."""
    if len(bases) not in (2, 3):
        raise ValueError(f"2 or 3 bases, got {len(bases)}")
    nm = tuple(int(b.shape[0]) for b in bases)
    nq = tuple(int(b.shape[1]) for b in bases)
    nm_tot, e = in_coa.shape
    assert nm_tot == math.prod(nm), (in_coa.shape, nm)
    te, num_warps = element_tile(nq, jnp.dtype(in_coa.dtype).itemsize, te)
    nq0p = pl.next_power_of_2(nq[0])
    b0p = jnp.pad(bases[0], ((0, 0), (0, nq0p - nq[0])))
    kernel = _kernel3d if len(bases) == 3 else _kernel2d
    return common.triton_call(
        functools.partial(kernel, nm=nm, nq=nq, te=te, n_elem=e,
                          acc=common.acc_dtype(in_coa.dtype)),
        out_shape=jax.ShapeDtypeStruct((math.prod(nq), e), in_coa.dtype),
        grid=(pl.cdiv(e, te),), num_warps=num_warps, interpret=interpret,
        name=f"bwdtrans{len(bases)}d_qp_shared",
    )(b0p, *bases[1:], in_coa)
