"""XLA library-tier reductions for benchmark01.

The reference's library tiers are Kokkos::parallel_reduce and
thrust::transform_reduce (benchmark01/benchmark01.cc:197-228); the
equivalents are plain jnp reductions compiled by XLA.

Each takes an `eps` scalar folded into the elementwise transform (0.0 in
normal use); the chained timing protocol threads its data dependence through
it, and XLA fuses the scalar broadcast-add into the reduction so it costs no
extra memory traffic (see core/timing.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_bench.kernels import common


@jax.jit
def sumsq(x, eps=0.0):
    """Kokkos parallel_reduce analog: XLA elementwise-square + reduce."""
    w = x + jnp.asarray(eps, x.dtype)
    return jnp.sum(w * w, dtype=common.acc_dtype(x.dtype))


@jax.jit
def sumsq_dot(x, eps=0.0):
    """thrust::transform_reduce analog: a self-dot contraction."""
    acc = common.acc_dtype(x.dtype)
    w = x + jnp.asarray(eps, x.dtype)
    return jax.lax.dot_general(
        w, w,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=acc,
        precision=jax.lax.Precision.HIGHEST,
    )
