"""Headline benchmark: one JSON line.

Metric: benchmark05 (3D BwdTrans hex, nq=8^3) best-variant throughput in
GDOF/s at nelmt=131072, the reference suite's flagship workload, on the GPU.
vs_baseline compares against the reference's best committed number for the
same configuration: Cuda QP/Shared peak 28.91 GDOF/s on its own A100-class
GPU (BASELINE.md, benchmark05/nq8x8x8.log).

Prints exactly one JSON line on stdout; the device, its power limit and
every variant's rate go to stderr.  Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys

BASELINE_GDOFS = 28.91  # reference b05 nq=8^3 peak (BASELINE.md)
NELMT = 131072


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"bench: {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {smi.stdout.strip()}", file=sys.stderr)

    from gpu_bench.core.config import Config
    from gpu_bench.core.timing import eps_chain, measure
    from gpu_bench.benchmarks import benchmark05 as b05

    cfg = Config(n_tests=16)
    data = b05.prepare(8, 8, 8, NELMT, cfg)
    best = None
    for label, fn, args in b05.build_variants(data, cfg):
        t = measure(fn, args, cfg, chain_fn=eps_chain(fn, eps_arg=1))
        gdofs = 1e-9 * NELMT * 343 / t
        print(f"{label}: {gdofs:.2f} GDOF/s", file=sys.stderr)
        if best is None or gdofs > best[1]:
            best = (label, gdofs)
        del args

    print(json.dumps({
        "metric": f"b05 3D BwdTrans nq=8^3 nelmt={NELMT} ({best[0]})",
        "value": round(best[1], 2),
        "unit": "GDOF/s",
        "vs_baseline": round(best[1] / BASELINE_GDOFS, 3),
    }))


if __name__ == "__main__":
    main()
