"""One variant convention for all five benchmarks.

Each benchmark module defines

    variant_specs(data, cfg) -> ordered list of (label, fn, operand_keys)

— the analog of the reference's per-benchmark run_test<T> body timing 5-11
implementations of the same math in sequence (benchmark01/benchmark01.cc:
183-335, benchmark04/benchmark04.cc:428-1056).  The ordered labels are the
Case-line columns the postprocess scripts assume.  operand_keys resolve
through a mapping — a Layouts for b02/b04/b05 so expensive or consumable
operands materialize fresh, one variant at a time, inside the per-variant
fail-soft scope; a plain dict where everything is small and shared — and
by convention the key at index 1 names the small operand the chained timer
perturbs (for benchmarks timed via eps_chain).
"""

from __future__ import annotations


class Layouts:
    """Operand mapping with lazy derived layouts.

    Canonical arrays (the element stream in its two source layouts, bases,
    operators, epb knobs) are stored; derived layouts — the transposes /
    reshapes of the multi-GB element stream the individual variants
    consume — are materialized FRESH on each [] access and owned by the
    caller.  run_test resolves one variant's operands at a time and drops
    them afterwards, so at most one derived copy of the stream is resident
    alongside the canonicals, which bounds the residency of the largest
    sweep rows (nelmt=1,048,576 at the highest orders)."""

    def __init__(self, base: dict, derived: dict):
        self._base = dict(base)
        self._derived = dict(derived)

    def __getitem__(self, key):
        if key in self._base:
            return self._base[key]
        return self._derived[key]()

    def __setitem__(self, key, value):
        self._base[key] = value

    def __contains__(self, key):
        return key in self._base or key in self._derived

    def replace(self, **overrides) -> "Layouts":
        """Shallow copy with some base entries overridden (e.g. epb knobs)."""
        return Layouts({**self._base, **overrides}, self._derived)


def materialize(specs, data):
    """(label, fn, args) with every operand resolved up front — test-suite
    and small-size convenience.  Sweeps iterate variant_specs and resolve
    keys per variant instead, so lazy layouts stay one-at-a-time."""
    return [(label, fn, tuple(data[k] for k in keys))
            for label, fn, keys in specs]
