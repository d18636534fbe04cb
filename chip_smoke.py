"""Proof that the suite runs on one NVIDIA GPU, through its own entry points.

    python chip_smoke.py

Four phases, each a child process run one after the other, so that only
one process at a time holds the card (JAX reserves most of its memory);
this parent process never initialises JAX itself.

  device     the JAX device is a GPU; prints its kind and count, the JAX
             version, XLA_FLAGS and `nvidia-smi` name and power limit.
  kernels    the fused BwdTrans kernel (the only hand kernel), compiled by
             Triton, against the plain f64 NumPy reference
             (ops/bwdtrans.reference2d/3d): b05 nq in {2,4,6,8,10} at
             nelmt=131072 and b04 nq in {2,4,8,16,32} at nelmt=262144, f32
             and f64.  max|err|/max|ref| must be <= 1e-5 (f32) and 1e-12
             (f64); XLA(GEMM)'s error at TF32 is printed, not checked.
  bench      each benchmark CLI's main() once, above the 50 MB L2: b01 at
             2^28, b02 at 2^27, b03 at M=N=16384, b04 `8 8` at 2^20, b05
             `8 8 8` at 131072 in f32 and f64.  Fails on a WARNING, a
             non-zero exit, or a non-finite or empty column; prints the
             hand kernel's time beside the best XLA column's.
  gpu-tests  `python -m pytest -m gpu tests/`.

Exits non-zero if any phase fails (and when JAX finds no GPU, or the repo
is not next to this file).  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 1150  # the whole run, compilation included
DEVICE_TAG = "CHIP_SMOKE_DEVICE "
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def _smi() -> str:
    try:
        r = subprocess.run(SMI, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f"nvidia-smi unavailable: {ex}"
    return r.stdout.strip() or r.stderr.strip()


# ---- phases (run in child processes) -------------------------------------


def phase_device() -> int:
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__}; devices: {len(devs)} x {d.platform} "
          f"{d.device_kind!r}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"nvidia-smi: {_smi()}")
    if d.platform != "gpu":
        print(f"no GPU: JAX's default device is {d.platform!r}",
              file=sys.stderr)
        return 1
    print(DEVICE_TAG + json.dumps({"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devs)}))
    return 0


def _max_rel_err(out, ref, nelmt):
    """max|out[:, e] - ref| / max|ref| over every element (all elements of
    the benchmark stream carry the same modes), computed on the device."""
    import jax.numpy as jnp

    r = jnp.asarray(ref, jnp.float64)[:, None]
    err = jnp.max(jnp.abs(out[:, :nelmt].astype(jnp.float64) - r))
    return float(err) / float(jnp.max(jnp.abs(r)))


KERNEL_CASES = ((3, (2, 4, 6, 8, 10), 131072),
                (2, (2, 4, 8, 16, 32), 262144))


def phase_kernels() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)
    from gpu_bench.baselines import bwdtrans2d as xla_bt
    from gpu_bench.benchmarks import benchmark04 as b04, benchmark05 as b05
    from gpu_bench.core.config import Config, dot_precision
    from gpu_bench.kernels import bwdtrans as pl_bt
    from gpu_bench.ops import bwdtrans

    tf32 = dot_precision(jax.lax.Precision.DEFAULT, "float32")
    fails = 0
    for dim, orders, nelmt in KERNEL_CASES:
        for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
            cfg = Config(dtype=dtype)
            if cfg.interpret:
                print("FAIL the kernel would run in the interpreter")
                return 1
            for nq in orders:
                if dim == 3:
                    data = b05.prepare(nq, nq, nq, nelmt, cfg)
                    ref = bwdtrans.reference3d(data["basis"], 1)
                    bases, c_key = (data["b0"], data["b1"], data["b2"]), "c_coa3"
                else:
                    data = b04.prepare(nq, nq, nelmt, cfg)
                    ref = bwdtrans.reference2d(data["basis"], 1)
                    bases, c_key = (data["b0"], data["b1"]), "c_coa"
                x = data["in_coa"]
                t0 = time.perf_counter()
                out = jax.block_until_ready(
                    pl_bt.sum_factorization(x, *bases, te=data["te"],
                                            interpret=cfg.interpret))
                dt = time.perf_counter() - t0
                err = _max_rel_err(out, ref.reshape(-1), nelmt)
                del out
                ok = err <= tol
                fails += not ok
                extra = ""
                if dtype == "float32":
                    g = xla_bt.gemm_kron(x, data[c_key], precision=tf32)
                    extra = (f"; XLA(GEMM) at TF32 {_max_rel_err(g, ref.reshape(-1), nelmt):.3e}"
                             " (not checked)")
                    del g
                te, nw = pl_bt.element_tile((nq,) * dim, x.dtype.itemsize,
                                            data["te"])
                print(f"{'ok  ' if ok else 'FAIL'} b0{dim + 2} nq={nq} "
                      f"{dtype} nelmt={nelmt} te={te} warps={nw}: "
                      f"max|err|/max|ref| {err:.3e} <= {tol:g}"
                      f"{extra}; first call {dt:.1f}s", flush=True)
                del x, data
    return 1 if fails else 0


BENCH_RUNS = [
    ("b01", "benchmark01", ["--min-size", "268435456",
                            "--max-size", "268435456"]),
    ("b02", "benchmark02", ["--min-size", "134217728",
                            "--max-size", "134217728"]),
    ("b03", "benchmark03", ["--min-size", "16384", "--max-size", "16384"]),
    ("b04", "benchmark04", ["8", "8", "--min-size", "1048576",
                            "--max-size", "1048576"]),
    ("b05", "benchmark05", ["8", "8", "8", "--min-size", "131072",
                            "--max-size", "131072"]),
    ("b05 f64", "benchmark05", ["8", "8", "8", "--min-size", "131072",
                                "--max-size", "131072", "--dtype", "f64"]),
]


def _rows(log: str):
    """{size: (labels, norms, values)} from a CLI's Case/norm/rate lines."""
    rows = {}
    for line in log.splitlines():
        tok = line.split()
        if len(tok) < 3 or tok[0] not in ("Size", "nelmt"):
            continue
        r = rows.setdefault(tok[1], {})
        r[tok[2]] = tok[3:]
    return rows


def phase_bench() -> int:
    import contextlib
    import importlib
    import io
    import math

    fails = 0
    for name, module, argv in BENCH_RUNS:
        mod = importlib.import_module(f"gpu_bench.benchmarks.{module}")
        out, err = io.StringIO(), io.StringIO()
        code = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                mod.main(argv + ["--ntests", "5"])
            except SystemExit as ex:
                code = ex.code
        wall = time.perf_counter() - t0
        log = out.getvalue()
        print(log, end="")
        print(err.getvalue(), end="", file=sys.stderr)
        problems = []
        if code:
            problems.append(f"exit code {code}")
        if "WARNING" in err.getvalue():
            problems.append("WARNING in its notes")
        rows = _rows(log)
        if not rows:
            problems.append("no result row")
        for size, r in rows.items():
            labels = r.get("Case:", [])
            norms = [float(v) for v in r.get("norm:", [])]
            unit = "GB/s:" if "GB/s:" in r else "DOF/s:"
            rates = [float(v) for v in r.get(unit, [])]
            if not labels or len(norms) != len(labels) or len(rates) != len(labels):
                problems.append(f"size {size}: empty column")
            if not all(math.isfinite(v) and v > 0 for v in norms + rates):
                problems.append(f"size {size}: non-finite or zero column")
            xla = [v for lab, v in zip(labels, rates) if lab.startswith("XLA")]
            for lab, v in zip(labels, rates):
                if lab.startswith("Pallas") and xla and v > 0:
                    best = max(xla)
                    blab = labels[rates.index(best)]
                    print(f"{name} size {size}: {lab} {v:.4f} vs best XLA "
                          f"{blab} {best:.4f} (G{unit[:-1]}; "
                          f"{'kernel faster' if v > best else 'XLA faster'}, "
                          f"ratio {v / best:.3f})", flush=True)
        print(f"{'ok  ' if not problems else 'FAIL'} {name} "
              f"({wall:.1f}s){': ' + '; '.join(problems) if problems else ''}",
              flush=True)
        fails += bool(problems)
    return 1 if fails else 0


def phase_gpu_tests() -> int:
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu", "tests/",
                        "-q", "-p", "no:cacheprovider"], cwd=HERE,
                       capture_output=True, text=True)
    print(r.stdout[-6000:], end="")
    print(r.stderr[-3000:], end="", file=sys.stderr)
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or " passed" not in summary or "skipped" in summary:
        print(f"FAIL gpu-tests: rc {r.returncode}, {summary!r}")
        return 1
    return 0


PHASES = {"device": phase_device, "kernels": phase_kernels,
          "bench": phase_bench, "gpu-tests": phase_gpu_tests}


# ---- parent --------------------------------------------------------------


def _run_phase(name: str, budget: float):
    """Run one phase in its own process group; kill the group on timeout."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phase", name], cwd=HERE,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=max(budget, 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return 124, out
    return proc.returncode, out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--phase":
        sys.path.insert(0, HERE)
        return PHASES[argv[1]]()
    if argv:
        print(f"usage: python {os.path.basename(__file__)}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gpu_bench")):
        print("chip_smoke: the gpu_bench package is not next to this file",
              file=sys.stderr)
        return 1
    start = time.monotonic()
    device = None
    for name in PHASES:
        t0 = time.monotonic()
        print(f"=== phase {name}", flush=True)
        rc, out = _run_phase(name, DEADLINE_S - (t0 - start))
        for line in out.splitlines():
            if line.startswith(DEVICE_TAG):
                device = json.loads(line[len(DEVICE_TAG):])
            else:
                print(line)
        print(f"=== phase {name}: rc {rc}, {time.monotonic() - t0:.1f}s",
              flush=True)
        if rc != 0:
            print(f"chip_smoke: phase {name} failed (rc {rc})",
                  file=sys.stderr)
            return 1
    if device is None or device["platform"] != "gpu":
        print("chip_smoke: no GPU device reported", file=sys.stderr)
        return 1
    print(_smi())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
