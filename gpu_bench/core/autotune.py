"""Element-tile (epb) autotuner.

The reference exposes its tiling knobs as CLI positionals (`threads
elblocks`, benchmark04/benchmark04.cc:1058-1063) and tunes them by hand via
nq-sweep scripts.  The analog here is the fused kernel's element tile
(kernels/bwdtrans.element_tile).  This module picks it empirically: time
the kernel at each candidate tile (min-of-few protocol, the harness's own
timing) and keep the fastest, memoized on disk per (device kind,
benchmark, variant family, shape, dtype) so sweeps pay the tuning cost
once.

Usage (gated behind `--autotune`; the default is the kernel's 128-byte row
tile):

    te = autotune_epb("b05/qp_shared", shape_sig, lambda te: (fn, args),
                      cfg, e_pad, candidates=(16, 32, 64, 128))
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterable, Optional, Sequence, Tuple

import jax


_LOCK = threading.Lock()
_CACHE: Optional[dict] = None


def _cache_path() -> str:
    """GPU_BENCH_AUTOTUNE_CACHE, else <checkout>/.autotune.json."""
    return os.environ.get(
        "GPU_BENCH_AUTOTUNE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".autotune.json"),
    )


def _load_cache() -> dict:
    global _CACHE
    if _CACHE is None:
        try:
            with open(_cache_path()) as f:
                _CACHE = json.load(f)
        except Exception:
            _CACHE = {}
    return _CACHE


def _save_cache() -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_CACHE, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except Exception:
        pass  # cache is an optimization; never fail the run over it


def device_kind() -> str:
    try:
        return jax.devices()[0].device_kind.replace(" ", "_")
    except Exception:
        return "unknown"


def epb_candidates(e_pad: int, lo: int = 128, hi: int = 8192) -> list:
    """Powers of two in [lo, hi] that divide the padded element count."""
    out = []
    c = lo
    while c <= min(hi, e_pad):
        if e_pad % c == 0:
            out.append(c)
        c *= 2
    return out or [min(e_pad, lo)]


def autotune_epb(
    family: str,
    shape_sig: str,
    build: Callable[[int], Tuple[Callable, Sequence]],
    cfg,
    e_pad: int,
    candidates: Optional[Iterable[int]] = None,
    default: Optional[int] = None,
) -> int:
    """Return the fastest epb for `family` at `shape_sig`, memoized on disk.

    build(epb) -> (fn, args) constructs the jitted kernel closure to time;
    timing uses the harness's measure() with a reduced repetition count
    (tuning wants ranking, not publication-grade minima).
    """
    from gpu_bench.core.timing import eps_chain, measure

    key = "|".join(
        [device_kind(), family, shape_sig, str(jax.numpy.dtype(cfg.dtype))]
    )
    with _LOCK:
        cache = _load_cache()
        if key in cache:
            epb = int(cache[key])
            if e_pad % epb == 0:
                return epb

    # only tiles that divide the padded element count are tried, so no
    # candidate times a masked tail the others do not
    cands = [c for c in (list(candidates) if candidates is not None
                         else epb_candidates(e_pad)) if e_pad % c == 0]
    if default is not None and default not in cands and e_pad % default == 0:
        cands.append(default)
    if not cands:
        cands = epb_candidates(e_pad)

    import dataclasses

    tune_cfg = dataclasses.replace(cfg, n_tests=max(4, cfg.n_tests // 8))
    best_epb, best_t = None, float("inf")
    for epb in cands:
        try:
            fn, args = build(epb)
            t = measure(fn, args, tune_cfg, chain_fn=eps_chain(fn, eps_arg=1))
        except Exception:
            continue  # candidate fails to compile or run: skip
        if t < best_t:
            best_epb, best_t = epb, t
    if best_epb is None:  # every candidate failed: fall back to a divisor
        if default is not None and e_pad % default == 0:
            best_epb = default
        else:
            best_epb = cands[0]

    with _LOCK:
        _load_cache()[key] = int(best_epb)
        _save_cache()
    return best_epb
