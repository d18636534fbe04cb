#!/bin/bash
# nq sweep driver for benchmark04 — the analog of benchmark04/run.sh:1-8
# (same log naming contract: nq{i}x{i}.log, stdout+stderr redirected).
# Usage: scripts/run04.sh [outdir] [extra benchmark04 flags...]
set -u
OUT=${1:-results/b04}
shift 2>/dev/null || true
mkdir -p "$OUT"
for i in 2 4 6 8 10 12 14 16 32; do
    python -m gpu_bench.benchmarks.benchmark04 "$i" "$i" "$@" \
        &> "$OUT/nq${i}x${i}.log"
done
python "$(dirname "$0")/../postprocess/postprocess04.py" "$OUT"
