#!/bin/bash
# nq sweep driver for benchmark05 — the analog of benchmark05/run.sh:1-8
# (log naming contract: nq{i}x{i}x{i}.log).
# Usage: scripts/run05.sh [outdir] [extra benchmark05 flags...]
set -u
OUT=${1:-results/b05}
shift 2>/dev/null || true
mkdir -p "$OUT"
for i in 2 4 6 8 10; do
    python -m gpu_bench.benchmarks.benchmark05 "$i" "$i" "$i" "$@" \
        &> "$OUT/nq${i}x${i}x${i}.log"
done
python "$(dirname "$0")/../postprocess/postprocess05.py" "$OUT"
