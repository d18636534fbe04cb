"""XLA library-tier matvec for benchmark03.

Reference tiers: Kokkos hierarchical TeamPolicy reduction per row
(benchmark03/benchmark03.cc:130-149) and legacy cuBLAS gemv in row-major
('T') and column-major ('N') layouts (:181-186, :225-230).  Here:

  * rowsum:  explicit broadcast-multiply + per-row reduce (the per-row
             parallel_reduce idiom)
  * gemv_rm: dot_general on row-major A (the library gemv)
  * gemv_cm: dot_general on a column-major (transposed) copy of A — the
             layout comparison the reference's two cuBLAS calls make
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def rowsum(a, x):
    return jnp.sum(a * x[None, :], axis=1)


@functools.partial(jax.jit, static_argnames=("precision",))
def gemv_rm(a, x, precision=jax.lax.Precision.HIGHEST):
    return jax.lax.dot_general(
        a, x, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=a.dtype, precision=precision,
    )


@functools.partial(jax.jit, static_argnames=("precision",))
def gemv_cm(a_t, x, precision=jax.lax.Precision.HIGHEST):
    """a_t is A transposed, stored (N, M): contract over its major dim."""
    return jax.lax.dot_general(
        x, a_t, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=a_t.dtype, precision=precision,
    )
