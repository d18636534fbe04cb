"""Backend rules of core/config.py: where kernels interpret, the precision
the XLA columns pass, the compile-cache location, and the CLI exit code."""

import os
import subprocess
import sys

import jax
import pytest

from gpu_bench.core import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jax.lax.Precision
A = jax.lax.DotAlgorithmPreset


@pytest.mark.parametrize("backend,want", [("cpu", True), ("gpu", False)])
def test_default_interpret(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config._default_interpret() is want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_default_interpret_refuses_other_backends(monkeypatch, backend):
    """A kernel is never timed in the interpreter on an accelerator."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        config._default_interpret()


@pytest.mark.parametrize("precision,gpu,cpu", [
    (P.HIGHEST, A.F32_F32_F32, A.F32_F32_F32),
    (P.HIGH, A.TF32_TF32_F32_X3, P.HIGH),
    (P.DEFAULT, A.TF32_TF32_F32, P.DEFAULT),
])
def test_dot_precision_f32(monkeypatch, precision, gpu, cpu):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert config.dot_precision(precision, "float32") == gpu
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert config.dot_precision(precision, "float32") == cpu


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("precision", [P.HIGHEST, P.HIGH, P.DEFAULT])
def test_dot_precision_native_dtypes(monkeypatch, dtype, precision):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert config.dot_precision(precision, dtype) == P.HIGHEST


def test_cli_precision_flag():
    from gpu_bench.benchmarks import cli

    args = cli.build_parser("b05").parse_args(["--precision", "high"])
    cfg = config.Config.from_flags(args)
    assert cfg.precision == P.HIGH
    assert cfg.dot_precision == P.HIGH  # the CPU keeps full f32


@pytest.mark.parametrize("env", [None, "given"])
def test_compile_cache_location(tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache lives in <checkout>/.jax_cache."""
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env:
        want = e["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    r = subprocess.run(
        [sys.executable, "-c", "import jax, gpu_bench.core.config; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=e, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_cli_exits_nonzero_on_failure(monkeypatch, capsys):
    """A failed variant still prints its row, then the CLI exits 1."""
    from gpu_bench.baselines import reduction
    from gpu_bench.benchmarks import benchmark01 as b01

    b01.main(["--max-size", "2048", "--ntests", "2"])  # healthy: returns
    monkeypatch.setattr(reduction, "sumsq_dot", None)  # not callable
    with pytest.raises(SystemExit) as ex:
        b01.main(["--max-size", "2048", "--ntests", "2"])
    assert ex.value.code == 1
    out = capsys.readouterr()
    assert "Size 2048 GB/s:" in out.out and "WARNING" in out.err
