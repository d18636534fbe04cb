"""XLA library-tier streaming add for benchmark02.

Library tiers in the reference: Kokkos parallel_for and thrust::transform
(benchmark02/benchmark02.cc:73-128).  Both map to an XLA elementwise
add; the donated flavor aliases the output onto x for true in-place x += y
traffic (2 reads + 1 write), the functional flavor writes a fresh buffer.
"""

from __future__ import annotations

import jax


@jax.jit
def add(x, y):
    """Functional out-of-place add (thrust::transform analog)."""
    return x + y


def _add(x, y):
    return x + y


# In-place x += y via buffer donation (Kokkos parallel_for analog).
add_donated = jax.jit(_add, donate_argnums=(0,))
