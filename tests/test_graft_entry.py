"""Entry contract: entry() compile-checks one device, dryrun_multichip
runs the sharded step on the 8-device virtual CPU mesh."""

import sys
import os

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.shape == (8 ** 3, 512)  # (nqTot, E) coalesced output


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
