"""Shared CLI for the five benchmark drivers.

The reference takes positional argv only (b04: `nq0 nq1 threads elblocks`,
benchmark04/benchmark04.cc:1058-1063; b05 adds nq2; b01-b03 take none) with
hard-coded sweep bounds.  We keep the positional contract and add flags for
dtype, repetition count, sweep bounds, and the fused kernel's element tile
(the `threads`/`elblocks` analog).
"""

from __future__ import annotations

import argparse
import sys


def build_parser(name: str, positionals=()) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name)
    for pos, default in positionals:
        p.add_argument(pos, nargs="?", type=int, default=default)
    p.add_argument("--dtype", choices=["f32", "f64", "bf16"], default="f32",
                   help="element type (the reference's is f64)")
    p.add_argument("--ntests", type=int, default=40,
                   help="repetitions per variant; min is kept (reference: 40)")
    p.add_argument("--epb", type=int, default=None,
                   help="element tile of the fused BwdTrans kernel, a power "
                        "of two (threads/elblocks analog)")
    p.add_argument("--autotune", action="store_true",
                   help="pick the element tile empirically (memoized in "
                        "<checkout>/.autotune.json) instead of the default "
                        "128-byte row tile")
    p.add_argument("--precision", choices=["default", "high", "highest"],
                   default="highest",
                   help="f32 contractions of the XLA columns: highest = "
                        "IEEE f32, high = 3-pass TF32, default = TF32")
    p.add_argument("--min-size", type=int, default=None,
                   help="override sweep lower bound")
    p.add_argument("--max-size", type=int, default=None,
                   help="override sweep upper bound (inclusive)")
    p.add_argument("--step", type=int, default=2,
                   help="geometric sweep factor (reference: x2; larger "
                        "values thin the sweep for quicker runs)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip cross-variant norm agreement asserts")
    p.add_argument("--timing", choices=["auto", "dispatch", "chained"],
                   default="auto",
                   help="dispatch = reference-faithful per-launch timing; "
                        "chained = latency-cancelling kernel chains")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the sweep to DIR "
                        "(view with tensorboard/xprof; SURVEY.md §5.1)")
    return p


def profiled(args):
    """Context manager wrapping a sweep in jax.profiler.trace when
    --profile DIR was given (the reference has no tracer at all, SURVEY.md
    §5.1)."""
    import contextlib

    if getattr(args, "profile", None):
        import jax

        return jax.profiler.trace(args.profile)
    return contextlib.nullcontext()


def sweep(default_min: int, default_max: int, args):
    """Geometric sweep like the reference mains (benchmark01.cc:343)."""
    lo = args.min_size or default_min
    hi = args.max_size or default_max
    step = max(2, getattr(args, "step", 2))
    size = lo
    while size <= hi:
        yield size
        size *= step


def guarded(reporter, name, size, run, *args, **kwargs):
    """Run one sweep point, isolating per-size failures (e.g. a device
    OOM): the row is skipped with a WARNING and the sweep continues —
    partial logs stay usable, the append-to-log analog of the reference's
    redirect semantics (benchmark04/run.sh:6-7) — and finish() turns the
    failure into a non-zero exit."""
    try:
        run(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - deliberate per-row isolation
        reporter.warn(f"{name}: size {size} failed: {type(e).__name__}: {e}")


def finish(reporter) -> None:
    """End a CLI run: exit 1 if any variant, row or norm check failed."""
    if reporter.failures:
        reporter.note(f"{reporter.failures} failure(s); exiting 1")
        sys.exit(1)
