"""Module globals of both packages put back to their import-time values
around every test of the port that imports the JAX package.

The reference's launch code sets module globals and leaves them set:
``repro.launch.dryrun.build_lowerable`` switches moe's dispatch to
``"sort"`` (``src/repro/launch/dryrun.py:94``) and ``set_optimizations``
turns on the triangle walk, sequence-parallel prefill and the head
constraint.  The port's launch code installs hooks of its own
(``repro_torch.launch``).  pytest-xdist runs whole files on one worker in
any order, so a test that compares the packages would otherwise see what
an earlier file left.

Use: ``from torch_defaults import package_defaults  # noqa: F401`` in a
test module; pytest picks up a fixture imported into a module, and this
one is autouse.  A module that was never imported still holds its
defaults, so nothing is imported here: the card's machine, which has no
JAX, can import this file too.
"""
import sys

import pytest


def _module(name):
    return sys.modules.get(name)


def reset_globals() -> None:
    """Every module global that either package's launch code sets, back
    to its import-time default (through the setters where they exist)."""
    if m := _module("repro.models.moe"):
        m.set_dispatch_impl("einsum")
    if m := _module("repro.core.attention"):
        m.set_block_skip(False)
        m.set_sp_prefill(None)
    if m := _module("repro.models.common"):
        m.set_head_constraint(None)
    if m := _module("repro.launch.dryrun"):
        m._OPTS.clear()
    if m := _module("repro_torch.models.moe"):
        m.set_dispatch_impl("einsum")
        m.set_sharded_ffn(None)
    if m := _module("repro_torch.core.attention"):
        m.set_sp_prefill(None)
        m.set_flash_placements(None)
    if m := _module("repro_torch.models.common"):
        m.set_head_constraint(None)
        m.set_sharded_serve()
    if m := _module("repro_torch.models.registry"):
        m.set_sharded_nll(None)
    if m := _module("repro_torch.core.kvcache"):
        m.set_sharded_append(None)
    if m := _module("repro_torch.launch.dryrun"):
        m._OPTS.clear()


@pytest.fixture(autouse=True)
def package_defaults():
    """Both packages' launch globals at their defaults before the test
    and again after it."""
    reset_globals()
    yield
    reset_globals()
