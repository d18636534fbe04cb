"""Shared machinery for the 2D/3D tensor-product sum-factorization
("BwdTrans") benchmarks.

Math (2D, reference semantics from benchmark04/benchmark04.cc:489-523):

    out[e, j, i] = sum_{q, p} in[e, q, p] * B0[p, i] * B1[q, j]

with nm_d = nq_d - 1 modes per direction (:437-438), element data
in[e, q, p] = sin(q*nm0 + p + 1) (identical for every element, :470-477) and
basis B_d[m, n] = cos(m*nq_d + n) (:478-486).  3D adds a third contraction
(B2, out[e,k,j,i]; benchmark05/benchmark05.cc:695-740).

Two storage layouts, mirroring the reference's uncoalesced/coalesced pair
(:859-875): element-major (E, nmTot) with the element index on the slow
axis, and "coalesced" (nmTot, E) with the element index on the minor axis,
so consecutive threads touch consecutive elements.

Operator matrix (device-built, untimed prep):
    C_em  = kron(B1, B0)   (nmTot, nqTot): out_em2 = in_em2 @ C_em
(the coalesced GEMM uses its transpose).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gpu_bench.core.variants import Layouts  # noqa: F401  (re-export)
import numpy as np

from gpu_bench.ops import initdata
from gpu_bench.utils import native


@dataclasses.dataclass
class Basis2D:
    nq0: int
    nq1: int
    b0: jax.Array  # (nm0, nq0)
    b1: jax.Array  # (nm1, nq1)

    @property
    def nm0(self):
        return self.nq0 - 1

    @property
    def nm1(self):
        return self.nq1 - 1

    @property
    def nm_tot(self):
        return self.nm0 * self.nm1

    @property
    def nq_tot(self):
        return self.nq0 * self.nq1


def make_basis2d(nq0: int, nq1: int, dtype) -> Basis2D:
    nm0, nm1 = nq0 - 1, nq1 - 1
    return Basis2D(
        nq0=nq0,
        nq1=nq1,
        b0=initdata.host_basis_cos(nm0, nq0, dtype),
        b1=initdata.host_basis_cos(nm1, nq1, dtype),
    )


def element_data2d(basis: Basis2D, dtype) -> jax.Array:
    """One element's mode coefficients, flat (nmTot,): sin(l+1)."""
    return jnp.asarray(native.init_sin1(basis.nm_tot), dtype=dtype)


def make_inputs2d(basis: Basis2D, nelmt: int, nelmt_pad: int, dtype):
    """(in_em2 (E_pad, nmTot), in_coa (nmTot, E_pad)): identical per-element
    data, with zeroed padding elements beyond nelmt (inert in norms)."""
    elem = element_data2d(basis, dtype)
    in_em2 = jnp.tile(elem[None, :], (nelmt_pad, 1))
    if nelmt_pad != nelmt:
        mask = (jnp.arange(nelmt_pad) < nelmt)[:, None]
        in_em2 = jnp.where(mask, in_em2, jnp.zeros((), dtype))
    in_coa = jnp.asarray(in_em2.T)
    return in_em2, in_coa


def operator2d(basis: Basis2D):
    """Dense kron operator C_em = kron(B1, B0) (nmTot, nqTot)."""
    return jnp.kron(basis.b1, basis.b0)


def _mask_trailing(x, nelmt, e_pad, dtype):
    if e_pad == nelmt:
        return jnp.asarray(x)
    mask = jnp.arange(e_pad) < nelmt
    return jnp.where(mask, x, jnp.zeros((), dtype))


def stream_sources(elem_flat, nm_shape, nelmt: int, e_pad: int, dtype):
    """Per-layout builders of the element stream, each materializing
    straight from the per-element coefficient vector — no cross-layout
    intermediates, so a sweep's resident set is ONE layout at a time.
    (The reference host-initializes both layouts up front,
    benchmark04/benchmark04.cc:859-875.)

    nm_shape is (nm1, nm0) in 2D or (nm2, nm1, nm0) in 3D.  Builders:
      em2        (E, nmTot)           element-major
      coa        (nmTot, E)           coalesced (element index minor)
    """
    nm_shape = tuple(int(n) for n in nm_shape)
    nm_tot = 1
    for n in nm_shape:
        nm_tot *= n
    elem = jnp.asarray(elem_flat, dtype=dtype)

    def em2():
        x = jnp.broadcast_to(elem[None, :], (e_pad, nm_tot))
        if e_pad != nelmt:
            mask = (jnp.arange(e_pad) < nelmt)[:, None]
            x = jnp.where(mask, x, jnp.zeros((), dtype))
        return jnp.asarray(x)

    def coa():
        x = jnp.broadcast_to(elem[:, None], (nm_tot, e_pad))
        return _mask_trailing(x, nelmt, e_pad, dtype)

    return dict(em2=em2, coa=coa)


def choose_xla_chunk(fixed_bytes: int, w_bytes_per_elem: int, e_pad: int,
                     cap: int):
    """Element-chunk width for the XLA staged tiers (None = no chunking):
    chunk only when fixed residency (input + two chain-carried outputs)
    plus the full-size stage workspaces would overflow the sweep cap, and
    then pick the largest power-of-two ce whose ~two in-flight workspace
    chunks still fit.  Floored at 64Ki elements so a chunk's workspace
    stays large and the staged variants keep their HBM round-trip
    semantics (baselines.chunk_elems)."""
    if fixed_bytes + w_bytes_per_elem * e_pad <= cap:
        return None
    ce = 65536
    while (ce * 2 < e_pad
           and fixed_bytes + 2 * w_bytes_per_elem * (ce * 2) <= cap):
        ce *= 2
    return min(ce, e_pad)


# ---- 3D (benchmark05) ---------------------------------------------------


@dataclasses.dataclass
class Basis3D:
    nq0: int
    nq1: int
    nq2: int
    b0: jax.Array  # (nm0, nq0)
    b1: jax.Array  # (nm1, nq1)
    b2: jax.Array  # (nm2, nq2)

    @property
    def nm0(self):
        return self.nq0 - 1

    @property
    def nm1(self):
        return self.nq1 - 1

    @property
    def nm2(self):
        return self.nq2 - 1

    @property
    def nm_tot(self):
        return self.nm0 * self.nm1 * self.nm2

    @property
    def nq_tot(self):
        return self.nq0 * self.nq1 * self.nq2


def make_basis3d(nq0: int, nq1: int, nq2: int, dtype) -> Basis3D:
    return Basis3D(
        nq0=nq0, nq1=nq1, nq2=nq2,
        b0=initdata.host_basis_cos(nq0 - 1, nq0, dtype),
        b1=initdata.host_basis_cos(nq1 - 1, nq1, dtype),
        b2=initdata.host_basis_cos(nq2 - 1, nq2, dtype),
    )


def element_data3d(basis: Basis3D, dtype) -> jax.Array:
    """One element's mode coefficients, flat (nmTot,) with rows (r,q,p)
    p-minor: sin(flat+1) (benchmark05/benchmark05.cc:666-672)."""
    return jnp.asarray(native.init_sin1(basis.nm_tot), dtype=dtype)


def make_inputs3d(basis: Basis3D, nelmt: int, nelmt_pad: int, dtype):
    """(in_em2 (E_pad, nmTot3), in_coa (nmTot3, E_pad)); rows flat (r,q,p)
    with p minor, values sin(flat+1) (benchmark05/benchmark05.cc:666-672)."""
    elem = jnp.asarray(native.init_sin1(basis.nm_tot), dtype=dtype)
    in_em2 = jnp.tile(elem[None, :], (nelmt_pad, 1))
    if nelmt_pad != nelmt:
        mask = (jnp.arange(nelmt_pad) < nelmt)[:, None]
        in_em2 = jnp.where(mask, in_em2, jnp.zeros((), dtype))
    in_coa = jnp.asarray(in_em2.T)
    return in_em2, in_coa


def operator3d(basis: Basis3D):
    """Dense kron operator C_em3 = kron(B2, B1, B0) (nmTot3, nqTot3), the
    single-GEMM form."""
    return jnp.kron(basis.b2, jnp.kron(basis.b1, basis.b0))


def reference3d(basis: Basis3D, nelmt: int) -> np.ndarray:
    """f64 oracle out (nelmt, nq2, nq1, nq0)."""
    elem = native.init_sin1(basis.nm_tot)
    inp = np.broadcast_to(elem, (nelmt, basis.nm_tot)).reshape(
        nelmt, basis.nm2, basis.nm1, basis.nm0
    )
    b0 = native.init_cos(basis.nm0 * basis.nq0).reshape(basis.nm0, basis.nq0)
    b1 = native.init_cos(basis.nm1 * basis.nq1).reshape(basis.nm1, basis.nq1)
    b2 = native.init_cos(basis.nm2 * basis.nq2).reshape(basis.nm2, basis.nq2)
    return native.bwdtrans3d_ref(inp, b0, b1, b2)


# ---- f64 reference (test oracle plumbing) -------------------------------


def reference2d(basis: Basis2D, nelmt: int) -> np.ndarray:
    """f64 oracle out (nelmt, nq1, nq0) via the native/NumPy reference."""
    elem = native.init_sin1(basis.nm_tot)
    inp = np.broadcast_to(elem, (nelmt, basis.nm_tot)).reshape(
        nelmt, basis.nm1, basis.nm0
    )
    b0 = native.init_cos(basis.nm0 * basis.nq0).reshape(basis.nm0, basis.nq0)
    b1 = native.init_cos(basis.nm1 * basis.nq1).reshape(basis.nm1, basis.nq1)
    return native.bwdtrans2d_ref(inp, b0, b1)
