"""Tests that need the card: the fused kernel compiled by Triton (no
interpreter) against the f64 reference at every cell order.

Run on the GPU machine with `python -m pytest -m gpu tests/`.  The test
session itself is pinned to the CPU (conftest.py), so each test runs its
check in a child process that sees the GPU; here, without a card, they
skip."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
import sys
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, "tests")
from gpu_bench.core.config import Config
from gpu_bench.kernels import bwdtrans as pl_bt
from kernel_cases import TOL, random_case, rel_err
dim, dtype = int(sys.argv[1]), sys.argv[2]
assert jax.devices()[0].platform == "gpu"
assert Config().interpret is False
orders = (2, 4, 6, 8, 10, 12, 14, 16, 32) if dim == 2 else (2, 4, 6, 8, 10)
for nq in orders:
    x, bases, ref = random_case(dim, nq, 1000, dtype, seed=nq)
    err = rel_err(pl_bt.sum_factorization(x, *bases), ref)
    print(dim, nq, dtype, err)
    assert err <= TOL[dtype], (nq, err)
"""


@pytest.fixture
def gpu_env():
    """Environment for a child process on the card; skips without one."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (run `pytest -m gpu` on the card)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_compiled_kernel_matches_reference(gpu_env, dim, dtype):
    r = subprocess.run([sys.executable, "-c", CHECK, str(dim), dtype],
                       cwd=REPO, env=gpu_env, capture_output=True, text=True,
                       timeout=900)
    print(r.stdout)
    assert r.returncode == 0, r.stderr[-4000:]
