"""ctypes bindings for the native runtime library (gpu_bench/native).

Every entry point has a NumPy fallback so the framework runs without the
shared library; when libgpubench.so is present (built by `make -C
gpu_bench/native` or automatically on first import) the native OpenMP paths
are used for host-side data initialization and the f64 validation oracles.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgpubench.so")

_lib = None
monotonic_ns = None  # callable or None


def _try_build() -> bool:
    if os.environ.get("GPU_BENCH_NO_NATIVE_BUILD"):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    c_dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.tb_monotonic_ns.restype = ctypes.c_int64
    lib.tb_init_mod13.argtypes = [c_dp, i64]
    lib.tb_init_mod8.argtypes = [c_dp, i64]
    lib.tb_init_sin1.argtypes = [c_dp, i64]
    lib.tb_init_cos.argtypes = [c_dp, i64]
    lib.tb_l2norm_sq.argtypes = [c_dp, i64]
    lib.tb_l2norm_sq.restype = ctypes.c_double
    lib.tb_dot.argtypes = [c_dp, c_dp, i64]
    lib.tb_dot.restype = ctypes.c_double
    lib.tb_matvec_ref.argtypes = [c_dp, c_dp, c_dp, i64, i64]
    lib.tb_bwdtrans2d_ref.argtypes = [c_dp] * 4 + [i64] * 5
    lib.tb_bwdtrans3d_ref.argtypes = [c_dp] * 5 + [i64] * 7
    return lib


_lib = _load()
if _lib is not None:
    monotonic_ns = _lib.tb_monotonic_ns

available = _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _out(n: int) -> np.ndarray:
    return np.empty(n, dtype=np.float64)


# ---- initializers (f64; benchmark harnesses cast to the run dtype) ------


def init_mod13(n: int) -> np.ndarray:
    """x[i] = i%13 + (0.2 + 1e-5*(i%100191)) — benchmark01/benchmark01.cc:178."""
    if _lib is not None:
        out = _out(n)
        _lib.tb_init_mod13(_ptr(out), n)
        return out
    i = np.arange(n, dtype=np.int64)
    return (i % 13).astype(np.float64) + (0.2 + 0.00001 * (i % 100191))


def init_mod8(n: int) -> np.ndarray:
    """y[i] = i%8 + (0.4 + 3e-5*(i%100721)) — benchmark02/benchmark02.cc:143."""
    if _lib is not None:
        out = _out(n)
        _lib.tb_init_mod8(_ptr(out), n)
        return out
    i = np.arange(n, dtype=np.int64)
    return (i % 8).astype(np.float64) + (0.4 + 0.00003 * (i % 100721))


def init_sin1(n: int) -> np.ndarray:
    """a[l] = sin(l+1) — benchmark03/benchmark03.cc:161, b04/b05 element data."""
    if _lib is not None:
        out = _out(n)
        _lib.tb_init_sin1(_ptr(out), n)
        return out
    return np.sin(np.arange(1, n + 1, dtype=np.float64))


def init_cos(n: int) -> np.ndarray:
    """B[l] = cos(l) — benchmark04/benchmark04.cc:478-486 basis init."""
    if _lib is not None:
        out = _out(n)
        _lib.tb_init_cos(_ptr(out), n)
        return out
    return np.cos(np.arange(n, dtype=np.float64))


# ---- f64 oracles --------------------------------------------------------


def l2norm(x: np.ndarray) -> float:
    x = np.ascontiguousarray(x, dtype=np.float64).ravel()
    if _lib is not None:
        return float(np.sqrt(_lib.tb_l2norm_sq(_ptr(x), x.size)))
    return float(np.linalg.norm(x))


def matvec_ref(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    A = np.ascontiguousarray(A, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    if _lib is not None:
        m, n = A.shape
        y = _out(m)
        _lib.tb_matvec_ref(_ptr(A), _ptr(x), _ptr(y), m, n)
        return y
    return A @ x


def bwdtrans2d_ref(
    inp: np.ndarray, b0: np.ndarray, b1: np.ndarray
) -> np.ndarray:
    """out[e,j,i] = sum_{q,p} in[e,q,p] b0[p,i] b1[q,j] (f64)."""
    inp = np.ascontiguousarray(inp, dtype=np.float64)
    b0 = np.ascontiguousarray(b0, dtype=np.float64)
    b1 = np.ascontiguousarray(b1, dtype=np.float64)
    nelmt, nm1, nm0 = inp.shape
    nq0 = b0.shape[1]
    nq1 = b1.shape[1]
    if _lib is not None:
        out = _out(nelmt * nq0 * nq1)
        _lib.tb_bwdtrans2d_ref(
            _ptr(inp), _ptr(b0), _ptr(b1), _ptr(out), nelmt, nq0, nq1, nm0, nm1
        )
        return out.reshape(nelmt, nq1, nq0)
    return np.einsum("eqp,pi,qj->eji", inp, b0, b1, optimize=True)


def bwdtrans3d_ref(
    inp: np.ndarray, b0: np.ndarray, b1: np.ndarray, b2: np.ndarray
) -> np.ndarray:
    """out[e,k,j,i] = sum_{r,q,p} in[e,r,q,p] b0[p,i] b1[q,j] b2[r,k] (f64)."""
    inp = np.ascontiguousarray(inp, dtype=np.float64)
    b0 = np.ascontiguousarray(b0, dtype=np.float64)
    b1 = np.ascontiguousarray(b1, dtype=np.float64)
    b2 = np.ascontiguousarray(b2, dtype=np.float64)
    nelmt, nm2, nm1, nm0 = inp.shape
    nq0, nq1, nq2 = b0.shape[1], b1.shape[1], b2.shape[1]
    if _lib is not None:
        out = _out(nelmt * nq0 * nq1 * nq2)
        _lib.tb_bwdtrans3d_ref(
            _ptr(inp), _ptr(b0), _ptr(b1), _ptr(b2), _ptr(out),
            nelmt, nq0, nq1, nq2, nm0, nm1, nm2,
        )
        return out.reshape(nelmt, nq2, nq1, nq0)
    return np.einsum("erqp,pi,qj,rk->ekji", inp, b0, b1, b2, optimize=True)
