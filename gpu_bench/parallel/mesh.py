"""Multi-device element-parallel execution over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2.3/§5.8) — this module is
the additive scaling layer: the BwdTrans operator distributed over a 2D
(dp, tp) device mesh with shard_map,

  * dp axis: elements sharded across devices (the data-parallel sweep —
    each device owns a contiguous slab of the element stream);
  * tp axis: the mode (contraction) dimension sharded, each device holding
    a column slice of the kron operator and the matching row slice of the
    element data; partial products are combined with a psum — the
    tensor-parallel contraction pattern;

plus a psum-reduced global norm, so validation stays exact under sharding.
Collectives are XLA's (jax.lax.psum, NCCL on GPUs); no hand-written
communication.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None,
              tp: Optional[int] = None) -> Mesh:
    """2D (dp, tp) mesh over the given devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    dev = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(dev, ("dp", "tp"))


def sharded_kron_apply(mesh: Mesh, precision=jax.lax.Precision.HIGHEST):
    """jitted (in_coa, c_coa) -> (out_coa, norm): the kron-operator BwdTrans
    with elements on dp, the contraction dimension on tp (psum over tp),
    and a globally psum-reduced output norm."""

    def local_step(in_local, c_local):
        # in_local: (nmTot/tp, E/dp); c_local: (nqTot, nmTot/tp)
        partial = jnp.dot(c_local, in_local, precision=precision,
                          preferred_element_type=in_local.dtype)
        out_local = jax.lax.psum(partial, "tp")
        acc = jnp.float64 if out_local.dtype == jnp.float64 else jnp.float32
        sumsq = jnp.sum(out_local.astype(acc) ** 2)
        # tp ranks hold identical out_local; reduce over dp only
        norm_sq = jax.lax.psum(sumsq, "dp")
        return out_local, norm_sq

    mapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("tp", "dp"), P(None, "tp")),
        out_specs=(P(None, "dp"), P()),
    )

    @jax.jit
    def step(in_coa, c_coa):
        out, norm_sq = mapped(in_coa, c_coa)
        return out, jnp.sqrt(norm_sq)

    return step


def shard_inputs(mesh: Mesh, in_coa, c_coa):
    """Place operands with the shardings sharded_kron_apply expects.

    The contraction dimension (nmTot) is zero-padded up to a multiple of the
    tp axis size — zero rows of the element data and zero columns of the
    operator contribute nothing to the contraction."""
    tp = mesh.shape["tp"]
    nm_tot = in_coa.shape[0]
    pad = (-nm_tot) % tp
    if pad:
        in_coa = jnp.concatenate(
            [in_coa, jnp.zeros((pad, in_coa.shape[1]), in_coa.dtype)], axis=0)
        c_coa = jnp.concatenate(
            [c_coa, jnp.zeros((c_coa.shape[0], pad), c_coa.dtype)], axis=1)
    in_s = jax.device_put(in_coa, NamedSharding(mesh, P("tp", "dp")))
    c_s = jax.device_put(c_coa, NamedSharding(mesh, P(None, "tp")))
    return in_s, c_s


def sharded_elementwise_apply(mesh: Mesh, fn, with_norm: bool = True):
    """Element-only (pure dp) sharding for an arbitrary single-device
    variant fn(in_coa3, *ops): each device runs the full kernel on its
    element slab — the multi-device analog of the reference's element sweep.

    with_norm=False skips the psum-reduced validation norm (an extra full
    read of the output per application — exclude it from timed steps)."""

    def local_step(in_local, *ops):
        out_local = fn(in_local, *ops)
        if not with_norm:
            return (out_local,)
        acc = jnp.float64 if out_local.dtype == jnp.float64 else jnp.float32
        sumsq = jnp.sum(out_local.astype(acc) ** 2)
        return out_local, jax.lax.psum(jnp.atleast_1d(sumsq), ("dp", "tp"))

    def spec_nd(x):
        # elements live on the minor axis of every coalesced operand
        return P(*([None] * (x.ndim - 1) + [("dp", "tp")]))

    def make(in_arr, *ops):
        in_specs = (spec_nd(in_arr),) + tuple(P(*([None] * o.ndim))
                                              for o in ops)
        out_specs = ((spec_nd(in_arr), P(None)) if with_norm
                     else (spec_nd(in_arr),))
        # check_vma=False: pallas_call out_shapes don't carry vma metadata
        mapped = jax.shard_map(local_step, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
        return jax.jit(mapped)

    return make
