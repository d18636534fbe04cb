"""Deterministic benchmark inputs.

The reference initializes every operand with fixed analytic formulas so that
validation norms are reproducible machine-to-machine (SURVEY.md §4.2):

  b01/b02 x: i%13 + (0.2 + 1e-5*(i%100191))   benchmark01/benchmark01.cc:178
  b02 y:     i%8  + (0.4 + 3e-5*(i%100721))   benchmark02/benchmark02.cc:143
  b03 A:     sin(i*N + j + 1), x[j] = j       benchmark03/benchmark03.cc:161-167
  b04/b05:   in flat l -> sin(l+1) per element; basis flat l -> cos(l)
             benchmark04/benchmark04.cc:470-486

We reproduce them two ways:
  * device-side (jnp, iota-based) for the large streaming arrays of b01/b02 —
    the analog of the reference's set_data<<<>>> device init
    (benchmark01/benchmark01.cc:172-181), avoiding multi-GB host->device
    copies;
  * host-side (NumPy/native f64, then cast) where f32 evaluation of the
    formula would lose accuracy (sin of large arguments for b03-b05) or where
    a f64 oracle input is needed.

Integer mod is computed in int32 on device: sizes stay below 2^31 and f32
cannot represent large indices exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gpu_bench.utils import native


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _iota_i32(n: int) -> jax.Array:
    return jax.lax.iota(jnp.int32, n)


@jax.jit
def _device_mod13_f32(i: jax.Array) -> jax.Array:
    return (i % 13).astype(jnp.float32) + (
        0.2 + 0.00001 * (i % 100191).astype(jnp.float32)
    )


@jax.jit
def _device_mod8_f32(i: jax.Array) -> jax.Array:
    return (i % 8).astype(jnp.float32) + (
        0.4 + 0.00003 * (i % 100721).astype(jnp.float32)
    )


def device_x(n: int, dtype) -> jax.Array:
    """b01/b02 first operand, initialized on device."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        # f64 path: formula evaluated exactly on host
        return jnp.asarray(native.init_mod13(n))
    return _device_mod13_f32(_iota_i32(n)).astype(dtype)


def device_y(n: int, dtype) -> jax.Array:
    """b02 second operand, initialized on device."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return jnp.asarray(native.init_mod8(n))
    return _device_mod8_f32(_iota_i32(n)).astype(dtype)


def host_matrix_sin1(shape, dtype) -> jax.Array:
    """A[l] = sin(l+1), evaluated in f64 on host, cast to dtype, put on device."""
    n = int(np.prod(shape))
    return jnp.asarray(native.init_sin1(n).reshape(shape), dtype=dtype)


def host_basis_cos(nm: int, nq: int, dtype) -> jax.Array:
    """B[m, n] = cos(m*nq + n) as an (nm, nq) matrix."""
    b = native.init_cos(nm * nq).reshape(nm, nq)
    return jnp.asarray(b, dtype=dtype)


def host_x_linear(n: int, dtype) -> jax.Array:
    """b03 vector x[j] = j (benchmark03/benchmark03.cc:167)."""
    return jnp.asarray(np.arange(n, dtype=np.float64), dtype=dtype)
