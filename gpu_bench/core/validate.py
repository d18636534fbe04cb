"""Validation layer.

The reference's correctness oracle is the side-by-side L2 norm of every
variant's output (SURVEY.md §4): agreement across independent implementations
of the same math.  We keep that (the `norm:` log lines) and upgrade it from
eyeball-checking to programmatic asserts, plus NumPy/native f64 reference
implementations used by the pytest suite (gpu_bench/utils/native.py).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _norm_sq_f32(x: jax.Array) -> jax.Array:
    # Chunked pairwise-style accumulation keeps f32 summation error small for
    # the ~1e8-element outputs of the large sweep sizes.
    x = x.ravel()
    n = x.shape[0]
    chunk = 1 << 16
    if n > chunk and n % chunk == 0:
        partial = jnp.sum(
            (x * x).reshape(n // chunk, chunk), axis=-1, dtype=jnp.float32
        )
        return jnp.sum(partial, dtype=jnp.float32)
    return jnp.sum(x * x, dtype=jnp.float32)


def l2norm(x: jax.Array) -> float:
    """On-device L2 norm (f64 accumulation when x64 is live, else chunked f32)."""
    if x.dtype == jnp.float64:
        return float(jnp.sqrt(jnp.sum(x.ravel().astype(jnp.float64) ** 2)))
    return float(np.sqrt(_norm_sq_f32(x.astype(jnp.float32))))


def check_norm_agreement(
    labels: Sequence[str],
    norms: Sequence[float],
    rtol: float,
    context: str = "",
) -> list:
    """Assert all variant norms agree with the first finite one to rtol.

    Returns a list of human-readable mismatch strings (empty = all agree).
    Mirrors the reference's cross-variant norm columns
    (benchmark04/benchmark04.cc:1033-1041), asserted instead of eyeballed.
    NaN norms mark variants that failed to run (already reported) and are
    skipped; the reference norm is the first NON-NaN entry so a failed
    first variant cannot silence the whole check.
    """
    ref_idx = next((i for i, n in enumerate(norms) if n == n), None)
    if ref_idx is None:
        return [f"{context}: no variant produced a norm; nothing validated"]
    ref = norms[ref_idx]
    scale = max(abs(ref), 1e-300)
    mismatches = []
    for label, n in zip(labels[ref_idx + 1:], norms[ref_idx + 1:]):
        if n != n:  # NaN: variant failed, reported by measure_checked
            continue
        if abs(n - ref) / scale > rtol:
            mismatches.append(
                f"{context} norm mismatch: {labels[ref_idx]}={ref!r} vs "
                f"{label}={n!r} (rtol {rtol})"
            )
    return mismatches


_WARNED: dict = {}  # (label, message) -> occurrences, for dedup across sizes


def fail_soft(label, reporter, thunk):
    """Run thunk() -> (seconds, norm), isolating failures: a variant that
    cannot compile or run at this size reports (inf, nan) — a 0 entry in
    the throughput column — instead of killing the remaining columns of the
    sweep row.  The failure is counted (reporter.warn), so the CLI still
    exits non-zero at the end.  The single fail-soft code path for every
    benchmark harness.

    A variant that fails the same way at every sweep size would repeat the
    identical message dozens of times per log, so each distinct (variant,
    message) pair is printed twice — the second time with a suppression
    notice — then only counted."""
    try:
        return thunk()
    except Exception as ex:  # fail-soft per variant, loudly reported
        first = str(ex).splitlines()[0][:300] if str(ex) else repr(ex)
        key = (label, first)
        seen = _WARNED[key] = _WARNED.get(key, 0) + 1
        if seen == 1:
            reporter.warn(f"variant {label} failed: {first}")
        elif seen == 2:
            reporter.warn(f"variant {label} failed again with the same "
                          "error; suppressing identical repeats")
        else:
            reporter.warn(None)
        return float("inf"), float("nan")


def measure_checked(label, fn, args, cfg, reporter, norm_fn=None,
                    witness_norm=None, **measure_kwargs):
    """(seconds, norm) for one variant via fail_soft.

    In chained mode the validation norm is derived from the timing chain's
    completion witness (sumsq of the final output — exact because the
    chain's eps perturbation is 0.0), skipping a second compile of the bare
    kernel per variant and size.  norm_fn maps the variant's output to its
    norm on the dispatch-mode path (default: l2norm); witness_norm maps the
    witness (default: sqrt)."""
    import math

    from gpu_bench.core.timing import measure

    def thunk():
        t, w = measure(fn, args, cfg, with_witness=True, **measure_kwargs)
        if w is not None and math.isfinite(w):
            return t, (witness_norm(w) if witness_norm else math.sqrt(w))
        out = fn(*args)
        norm = (norm_fn or l2norm)(out)
        del out
        return t, norm

    return fail_soft(label, reporter, thunk)


def default_rtol(dtype) -> float:
    """Per-dtype cross-variant tolerance (SURVEY.md §7 hard-parts: f32 ~1e-5)."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return 1e-10
    if dtype == jnp.bfloat16:
        return 5e-2
    return 5e-4
