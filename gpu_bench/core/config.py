"""Run configuration shared by all five benchmarks.

The reference suite configures runs through positional argv plus hard-coded
sweep bounds (benchmark04/benchmark04.cc:1058-1075); we keep that positional
contract in each benchmark CLI and gather everything else (dtype, repetition
count, memory cap, element tile) here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp

# Persistent compilation cache: the suite compiles O(100) distinct (variant,
# size) programs per sweep.  JAX_COMPILATION_CACHE_DIR, when set, is honoured
# by JAX itself; otherwise the cache lives in the checkout.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}

# f32 contractions on the GPU: highest = IEEE f32, high = 3-pass TF32,
# default = 1-pass TF32 (about three decimal digits).
_F32_ALGORITHMS = {
    jax.lax.Precision.HIGHEST: jax.lax.DotAlgorithmPreset.F32_F32_F32,
    jax.lax.Precision.HIGH: jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
    jax.lax.Precision.DEFAULT: jax.lax.DotAlgorithmPreset.TF32_TF32_F32,
}


def dot_precision(precision, dtype):
    """The `precision` argument the XLA columns pass for `precision` at
    `dtype`.  f32 gets an explicit algorithm, so that `highest` can never
    silently run in TF32; f64 and bf16 contract natively.  XLA:CPU has no
    TF32, so there the f32 request stays a plain Precision (computed in
    full f32)."""
    if jnp.dtype(dtype) != jnp.float32:
        return jax.lax.Precision.HIGHEST
    if (precision != jax.lax.Precision.HIGHEST
            and jax.default_backend() == "cpu"):
        return precision
    return _F32_ALGORITHMS[precision]


def _default_interpret() -> bool:
    """Pallas kernels compile for the GPU and run in the interpreter on the
    CPU (the test suite).  Any other backend is an error: a kernel must
    never be timed in the interpreter."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"unsupported JAX backend {backend!r}: the Pallas "
                       "kernels target the GPU (Triton) or the CPU "
                       "interpreter")


def device_memory_bytes() -> int:
    """Per-device memory for sweep guards: the allocator's limit on the GPU,
    a fixed 8 GiB on the CPU (test runs keep sweeps modest)."""
    if jax.default_backend() == "cpu":
        return 8 * 1024**3
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError("device reports no memory_stats()['bytes_limit']")
    return int(stats["bytes_limit"])


@dataclasses.dataclass
class Config:
    """Knobs shared across benchmarks.

    n_tests=40 and the min-of-N protocol mirror the reference harness
    (benchmark01/benchmark01.cc:186, :208).  `epb` (elements per block) is
    the analog of the reference's `threads`/`elblocks` CLI knobs
    (benchmark04/benchmark04.cc:1060-1063): the element tile one Triton
    program of the fused kernel owns (kernels/bwdtrans.element_tile).
    """

    dtype: jnp.dtype = jnp.float32
    n_tests: int = 40
    interpret: Optional[bool] = None
    epb: Optional[int] = None  # element tile of the fused kernel (None = auto)
    # Fraction of device memory a sweep size may use.  Every element-stream
    # layout is built lazily per variant (ops.bwdtrans.stream_sources) and
    # the XLA tiers chunk their stage workspaces (baselines.chunk_elems),
    # so the worst per-variant residency is input + 2 outputs.
    mem_fraction: float = 0.80
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST
    validate: bool = True  # cross-variant norm agreement checks
    autotune: bool = False  # empirical element-tile selection (core/autotune.py)
    # "dispatch" = reference-faithful per-dispatch timing; "chained" =
    # latency-cancelling k-application chains (see core/timing.py); "auto"
    # picks chained when the host<->device sync round-trip exceeds 1 ms.
    timing: str = "auto"

    def __post_init__(self):
        if self.interpret is None:
            self.interpret = _default_interpret()
        self.dtype = jnp.dtype(self.dtype)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def mem_cap_bytes(self) -> int:
        return int(device_memory_bytes() * self.mem_fraction)

    @property
    def dot_precision(self):
        """Precision argument of the XLA columns (see dot_precision)."""
        return dot_precision(self.precision, self.dtype)

    @classmethod
    def from_flags(cls, args) -> "Config":
        """Build from an argparse namespace produced by benchmarks.cli.
        --dtype f64 enables x64 for the whole process, once, here."""
        dtype = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[
            args.dtype
        ]
        if args.dtype == "f64":
            jax.config.update("jax_enable_x64", True)
        return cls(
            dtype=dtype,
            n_tests=args.ntests,
            epb=args.epb,
            precision=_PRECISIONS[args.precision],
            validate=not args.no_validate,
            autotune=getattr(args, "autotune", False),
            timing=args.timing,
        )
