#!/bin/bash
# Full-suite driver: benchmarks 01-03 to outfile.log + the b04/b05 nq sweeps.
# Usage: scripts/runall.sh [artifact root] [extra flags...]
set -u
ROOT=${1:-results}
shift 2>/dev/null || true
HERE=$(dirname "$0")
for n in 01 02 03; do
    mkdir -p "$ROOT/b$n"
    python -m "gpu_bench.benchmarks.benchmark$n" "$@" \
        &> "$ROOT/b$n/outfile.log"
    python "$HERE/../postprocess/postprocess$n.py" "$ROOT/b$n"
done
"$HERE/run04.sh" "$ROOT/b04" "$@"
"$HERE/run05.sh" "$ROOT/b05" "$@"
