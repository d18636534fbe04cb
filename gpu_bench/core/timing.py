"""Timing harness.

Reference protocol (utils/timer.h:3-45 + benchmark01/benchmark01.cc:197-209):
wall-clock around each dispatch, device synced before stop(), 40 repetitions,
minimum kept.  We support that faithfully ("dispatch" mode) and keep a
"chained" mode for hosts whose sync round-trip buries kernel time:

Chained mode times ONE dispatch of k data-dependent applications of the
kernel — chained through an eps perturbation so XLA cannot CSE/hoist the
repeated work — and forces true completion by pulling a scalar probe of the
final output to the host.  Two chain lengths are measured and differenced,
so every fixed cost (dispatch, sync round-trip, probe transfer) cancels:

    t_kernel = (T(k_hi) - T(k_lo)) / (k_hi - k_lo)

Both modes keep the reference's min-of-N reduction.  Mode "auto" (default)
picks chained only when the measured sync latency exceeds 1 ms, so a local
GPU times per dispatch.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from gpu_bench.utils import native


def _now_ns() -> int:
    return time.perf_counter_ns()


class Timer:
    """Stopwatch with the reference Timer's interface (utils/timer.h:3-45)."""

    def __init__(self):
        self._start = 0
        self._stop = 0
        self._clock = native.monotonic_ns or _now_ns

    def start(self) -> None:
        self._start = self._clock()

    def stop(self) -> None:
        self._stop = self._clock()

    def elapsed_nanoseconds(self) -> int:
        return self._stop - self._start

    def elapsed_seconds(self) -> float:
        return (self._stop - self._start) * 1e-9


# ---------------------------------------------------------------------------
# sync latency probe
# ---------------------------------------------------------------------------

_SYNC_LATENCY: Optional[float] = None


@jax.jit
def _tiny_op(x):
    return x + 1.0


def sync_latency() -> float:
    """Measured host<->device sync round-trip (cached)."""
    global _SYNC_LATENCY
    if _SYNC_LATENCY is None:
        x = jnp.zeros((), jnp.float32)
        float(_tiny_op(x))  # compile
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            float(_tiny_op(x))
            best = min(best, time.perf_counter() - t0)
        _SYNC_LATENCY = best
    return _SYNC_LATENCY


# ---------------------------------------------------------------------------
# dispatch mode (reference-faithful)
# ---------------------------------------------------------------------------


def time_variant(
    step: Callable[[], object],
    n_tests: int = 40,
    warmup: Optional[Callable[[], object]] = None,
) -> float:
    """Minimum wall-clock seconds over n_tests dispatches (dispatch mode).

    `step` must issue the computation AND block until the device is done.
    `warmup`, when given, is run once untimed to populate the jit cache.
    """
    if warmup is not None:
        out = warmup()
        jax.block_until_ready(out)
    timer = Timer()
    best = float("inf")
    for _ in range(n_tests):
        timer.start()
        out = step()
        jax.block_until_ready(out)
        timer.stop()
        best = min(best, timer.elapsed_seconds())
    return best


# ---------------------------------------------------------------------------
# chained mode
# ---------------------------------------------------------------------------

def _default_probe(out):
    """Cheapest true-completion witness: one element of the output."""
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out.ravel()[0].astype(jnp.float32)


def _witness_sumsq(out):
    """Completion witness = chunked sum of squares of the final output.

    Serves two purposes: every output element is live (XLA cannot shrink
    the carried array), and — because the eps perturbation is exactly 0.0 —
    the final chain output equals one plain application of the kernel, so
    sqrt(witness) IS the validation norm.  Deriving the norm here saves a
    second compile of the bare kernel per (variant, size).  Chunked
    accumulation mirrors validate._norm_sq_f32 so printed norms agree with
    the CPU path."""
    if isinstance(out, (tuple, list)):
        out = out[0]
    x = out.ravel()
    acc = jnp.float64 if x.dtype == jnp.float64 else jnp.float32
    n = x.shape[0]
    chunk = 1 << 16
    if n > chunk and n % chunk == 0:
        partial = jnp.sum((x * x).reshape(n // chunk, chunk), axis=-1,
                          dtype=acc)
        return jnp.sum(partial, dtype=acc)
    return jnp.sum(x.astype(acc) * x.astype(acc), dtype=acc)


def build_chain(chain_fn: Callable, probe: Callable = _default_probe,
                carry: str = "array") -> Callable:
    """Return run_k(k, *args) -> f32 scalar: k serialized applications of
    chain_fn(p, *args), where p is the f32 probe of the previous output.

    chain_fn must fold p into its computation at negligible cost, e.g. by
    perturbing a small operand with eps = 0.0 * p.  This creates a true data
    dependence XLA cannot hoist or CSE (an optimization_barrier on the large
    operand does NOT work: XLA splits tuple barriers element-wise and then
    hoists the loop-invariant computation).

    Two further anti-elision measures, both load-bearing:
      * the loop CARRIES the full output array (not just the probe scalar) —
        a scalar carry lets XLA slice-propagate the probe through the body
        and shrink every iteration to a single output element;
      * the returned completion witness is sumsq(out_final), so every
        element of the carried array is live (one extra read, amortized
        over k) — and doubles as the validation norm (see _witness_sumsq).

    carry="scalar" carries only the probe through the loop and applies the
    final iteration outside it (witness/norm semantics unchanged).  This is
    ONLY sound when the variant's output is produced by a pallas_call: the
    kernel is opaque to XLA, so slice propagation cannot narrow it, and the
    sequential probe dependence still serializes iterations.  The payoff is
    buffer reuse — one output buffer alive instead of two loop-carried
    copies — for the largest rows of the heaviest nq sweeps.

    k is a traced value, so one compilation covers every chain length.
    """
    if carry == "scalar":

        @jax.jit
        def run_k_scalar(k, *args):
            def body(_, p):
                return probe(chain_fn(p, *args)).astype(jnp.float32)

            p = jax.lax.fori_loop(0, k - 1, body, jnp.float32(0.0))
            return _witness_sumsq(chain_fn(p, *args))

        return run_k_scalar

    @jax.jit
    def run_k(k, *args):
        out0 = chain_fn(jnp.float32(0.0), *args)

        def body(_, out_prev):
            p = probe(out_prev)
            return chain_fn(p, *args)

        out = jax.lax.fori_loop(1, k, body, out0)
        return _witness_sumsq(out)

    return run_k


def eps_chain(fn: Callable, eps_arg: int = 0) -> Callable:
    """Make a chain_fn that perturbs args[eps_arg] by 0.0*p before calling fn.

    Use on a SMALL operand (a vector, a basis matrix) so the perturbation's
    materialization cost is negligible next to the streamed traffic."""

    def chain_fn(p, *args):
        args = list(args)
        a = args[eps_arg]
        args[eps_arg] = a + (jnp.float32(0.0) * p).astype(a.dtype)
        return fn(*args)

    return chain_fn


def time_chained(
    run_k: Callable,
    args: Sequence,
    n_tests: int = 40,
) -> float:
    """Seconds per kernel application via two-point chain differencing.

    The chain length escalates until the timing window (T(k_hi) - T(k_lo))
    comfortably exceeds the sync-latency noise floor, so tiny kernels (ns-µs)
    are resolved even over a slow control link.

    Returns (seconds, witness): witness is the float value of run_k's
    completion scalar (sumsq of the final output for build_chain chains)."""
    witness = float(run_k(jnp.int32(1), *args))  # compile + warm
    lat = sync_latency()
    # The window must DWARF the link latency (3x, not a fraction of it):
    # the differenced minima each carry the latency jitter of their own
    # best rep, so a ~0.3*lat window leaves up to ~10% error that
    # min-of-reps turns into systematic inflation.  With diff > 3*lat
    # residual jitter bounds the error at the low single-digit percent
    # level.
    target = max(8e-3, 3.0 * lat)

    def timed(k):
        kk = jnp.int32(k)
        t0 = time.perf_counter()
        float(run_k(kk, *args))
        return time.perf_counter() - t0

    # scout the chain length with single runs (cheap: ~1.3x the final t_hi
    # in total), then min-of-reps only at the chosen level
    k_hi = 64
    while True:
        k_lo = max(1, k_hi // 8)
        t_hi = timed(k_hi)
        if (t_hi - timed(k_lo)) > target or t_hi > 2.0 or k_hi >= (1 << 20):
            break
        k_hi *= 8

    # long chains need fewer reps — the window already dwarfs jitter, so
    # min() is outlier rejection, not noise averaging
    reps = max(4, min(10, n_tests // 4))
    if t_hi > 0.5:
        reps = max(3, reps // 2)
    best_lo = min(timed(k_lo) for _ in range(reps))
    best_hi = min(timed(k_hi) for _ in range(reps))
    return _per_from_window(best_hi, best_lo, k_hi, k_lo), witness


def _per_from_window(best_hi: float, best_lo: float, k_hi: int,
                     k_lo: int) -> float:
    """Per-application seconds from the two-point window.

    A non-positive difference means link noise exceeded the window.  Never
    fabricate throughput from a broken
    window — fall back to the whole-chain bound best_hi/k_hi, which still
    contains the fixed dispatch/sync cost and therefore UNDER-states
    throughput (honest direction)."""
    per = (best_hi - best_lo) / (k_hi - k_lo)
    if per <= 0.0:
        return best_hi / k_hi
    return per


def resolve_mode(cfg) -> str:
    mode = getattr(cfg, "timing", "auto")
    if mode == "auto":
        mode = "chained" if sync_latency() > 1e-3 else "dispatch"
    return mode


def measure(
    fn: Callable,
    args: Sequence,
    cfg,
    chain_fn: Optional[Callable] = None,
    probe: Callable = _default_probe,
    step: Optional[Callable[[], object]] = None,
    warmup: Optional[Callable[[], object]] = None,
    with_witness: bool = False,
    carry: str = "array",
) -> float:
    """Time one application of fn(*args) per the configured timing mode.

    chain_fn(p, *args) is the latency-cancelling chained step (see
    build_chain); when omitted, chained mode perturbs args[0] — only correct
    when args[0] is cheap to rematerialize.  carry="scalar" halves output
    residency for pallas_call-backed variants (see build_chain).

    with_witness=True returns (seconds, witness) where witness is the
    chain's completion sumsq (None in dispatch mode — the caller applies
    the kernel itself there, which dispatch mode has already compiled).
    """
    mode = resolve_mode(cfg)
    if mode == "chained":
        run_k = build_chain(chain_fn if chain_fn is not None else eps_chain(fn),
                            probe=probe, carry=carry)
        t, witness = time_chained(run_k, args, n_tests=cfg.n_tests)
        return (t, witness) if with_witness else t
    if step is None:
        step = lambda: fn(*args)
    t = time_variant(step, n_tests=cfg.n_tests, warmup=warmup or step)
    return (t, None) if with_witness else t
