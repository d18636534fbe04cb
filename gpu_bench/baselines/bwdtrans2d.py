"""XLA library-tier 2D BwdTrans variants for benchmark04.

Reference tiers: four Kokkos formulations (uncoalesced/coalesced flat
parallel_for, TeamPolicy QP, TeamPolicy QP + team_scratch;
benchmark04/benchmark04.cc:489-741) and the cuBLAS gemm +
gemmStridedBatched path (:799-825).  Here: einsum / dot_general
formulations compiled by XLA, plus a single kron-operator GEMM standing in
for the vendor-library tier (SURVEY.md §7 variant mapping).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def chunk_elems(fn, ce: int, axis: int = 0):
    """Apply fn to ce-element slices of the element axis and concatenate.

    The XLA-tier variants materialize HBM stage workspaces; at the largest
    sweep sizes the full-size workspace plus the chain-carried outputs
    exceeds HBM, so the element axis is cut into ce-element chunks (ce is
    chosen >= 64Ki, so each chunk's workspace stays large and the
    HBM round-trip semantics of the staged variants are preserved).  The
    static Python loop unrolls into sliced contractions writing into one
    concatenated output; per-element math and traffic are unchanged, so
    norms are identical to the unchunked form.
    """

    def run(x, *ops, precision=HIGHEST):
        e = x.shape[axis]
        if e <= ce:
            return fn(x, *ops, precision=precision)
        outs = [
            fn(jax.lax.slice_in_dim(x, j * ce, (j + 1) * ce, axis=axis),
               *ops, precision=precision)
            for j in range(e // ce)
        ]
        return jnp.concatenate(outs, axis=axis)

    return run


@functools.partial(jax.jit, static_argnames=("precision",))
def einsum_em(in_em3, b0, b1, precision=HIGHEST):
    """Element-major einsum (Kokkos uncoalesced analog): 'eqp,pi,qj->eji'."""
    return jnp.einsum("eqp,pi,qj->eji", in_em3, b0, b1, precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def einsum_coa(in_coa3, b0, b1, precision=HIGHEST):
    """Coalesced-layout einsum (Kokkos coalesced analog): 'qpe,pi,qj->jie'."""
    return jnp.einsum("qpe,pi,qj->jie", in_coa3, b0, b1, precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def staged_em(in_em3, b0, b1, precision=HIGHEST):
    """Explicit two-stage contraction with a materialized workspace
    (Kokkos QP analog)."""
    w = jnp.einsum("eqp,pi->eqi", in_em3, b0, precision=precision)
    return jnp.einsum("eqi,qj->eji", w, b1, precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def staged_dotgeneral(in_em3, b0, b1, precision=HIGHEST):
    """Two-stage via raw dot_general + transpose (Kokkos QP/shared analog)."""
    w = jax.lax.dot_general(in_em3, b0, (((2,), (0,)), ((), ())),
                            precision=precision)          # (E, nm1, nq0)
    out = jax.lax.dot_general(w, b1, (((1,), (0,)), ((), ())),
                              precision=precision)        # (E, nq0, nq1)
    return jnp.swapaxes(out, 1, 2)                         # (E, nq1, nq0)


@functools.partial(jax.jit, static_argnames=("precision",))
def gemm_kron(in_coa, c_coa, precision=HIGHEST):
    """Single library GEMM on the kron operator (cuBLAS-tier analog):
    out_coa = C_coa @ in_coa."""
    return jnp.dot(c_coa, in_coa, precision=precision,
                   preferred_element_type=in_coa.dtype)
