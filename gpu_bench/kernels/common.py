"""Shared helpers for the Pallas kernel tier (Triton route)."""

from __future__ import annotations

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def triton_call(kernel, *, out_shape, grid, num_warps: int,
                num_stages: int = 1, interpret: bool = False, name: str,
                **kwargs):
    """pl.pallas_call on the Triton route with its launch parameters.

    Every kernel of the repository goes through here, so the route is named
    once.  interpret=True runs the same kernel in the Pallas interpreter
    (CPU tests); on the GPU it compiles through Triton."""
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=grid, backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret, name=name, **kwargs)


def acc_dtype(dtype) -> jnp.dtype:
    """Accumulator dtype for in-kernel contractions: f64 stays f64, f32 and
    bf16 accumulate in f32."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (max(int(n), 1).bit_length() - 1)
