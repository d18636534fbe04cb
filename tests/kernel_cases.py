"""Shared cases for the fused BwdTrans kernel tests: the benchmark orders,
random inputs and the f64 NumPy reference."""

import jax.numpy as jnp
import numpy as np

from gpu_bench.utils import native

# every order of the b04 and b05 cells (ROADMAP north star)
B04_ORDERS = (2, 4, 6, 8, 10, 12, 14, 16, 32)
B05_ORDERS = (2, 4, 6, 8, 10)
DTYPES = ("float32", "float64", "bfloat16")
# max|err| / max|ref|: f32 and f64 as the chip check states them; bf16
# rounds the stored output to 8 bits
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-2}


def random_case(dim, nq, nelmt, dtype, seed=0):
    """(in_coa, bases, ref): in_coa (nmTot, nelmt) and bases in `dtype`;
    ref (nqTot, nelmt) is the f64 reference of the same (rounded) values."""
    rng = np.random.default_rng(seed)
    nm = nq - 1
    bases = [jnp.asarray(rng.uniform(-1, 1, (nm, nq)), dtype)
             for _ in range(dim)]
    x = jnp.asarray(rng.uniform(-1, 1, (nm ** dim, nelmt)), dtype)
    b64 = [np.asarray(b, np.float64) for b in bases]
    x64 = np.asarray(x, np.float64).T.reshape((nelmt,) + (nm,) * dim)
    if dim == 2:
        ref = native.bwdtrans2d_ref(x64, *b64)
    else:
        ref = native.bwdtrans3d_ref(x64, *b64)
    return x, bases, ref.reshape(nelmt, -1).T


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())
