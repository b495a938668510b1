"""Sequence-parallel prefill attention.

Port of ``repro.launch.spattn``.  For configs whose head counts do not
divide the model axis (arctic-480b: 56 query and 8 KV heads on a 16-way
model axis) neither head sharding nor replication works, so the
SEQUENCE is sharded over "model" instead:

* q, k and v enter S-sharded on "model" (B on the data axes);
* each rank all-gathers K and V over "model" and runs flash attention for
  its local rows at their absolute position, ``rank · S_local``
  (:func:`sp_local`: the flash kernels at a position offset);
* the output stays S-sharded.

The all-gather is differentiable: its backward reduce-scatters dK and dV,
summing each rank's contribution.  Causal load imbalance across ranks
(rank 0 attends to 1/n of what the last rank does) is a property of the
layout, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from .mesh import axis_names
from .sharding import activation_spec, placements


def sp_local(q_local: torch.Tensor, k_full: torch.Tensor,
             v_full: torch.Tensor, rank: int, *, causal: bool = True,
             window: Optional[int] = None) -> torch.Tensor:
    """One rank's share of sequence-parallel attention: its ``S_local``
    query rows q_local (B, S_local, H, D), at positions ``rank · S_local``
    on, against the whole sequence's k_full / v_full (B, S, Hkv, D).  The
    flash kernels on CUDA tensors, their plain versions on CPU tensors."""
    return ops.flash_prefill_attention(
        q_local, k_full, v_full, causal=causal, window=window,
        pos_offset=rank * q_local.shape[1])


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: the
    all-gather's backward reduce-scatters it, and torch 2.11's
    reduce-scatter refuses a strided input (the transpose's gradient)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def build_sp_prefill(mesh):
    """``fn(q, k, v, causal=True, window=None)`` → out, or None where the
    reference falls back (not causal, S not a multiple of the model axis,
    or Sk != S).  q, k, v are DTensors on ``mesh`` (or plain tensors,
    taken as replicated); the output is a DTensor sharded on the sequence
    over "model" and on the batch over the data axes where it divides
    them."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    names = axis_names(mesh)
    n_model = mesh.size(names.index("model"))
    group = mesh.get_group("model")
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd

    def gather_seq(t):
        """(B, S_local, h, D) → (B, S, h, D) over "model" (differentiable:
        the backward reduce-scatters), gathered along a leading S."""
        return _ContiguousGrad.apply(
            gather(t.transpose(0, 1).contiguous(), 0, group)).transpose(0, 1)

    def fn(q, k, v, causal=True, window=None):
        S = q.shape[1]
        if not causal or S % n_model or k.shape[1] != S:
            return None
        place = placements(activation_spec(mesh, q.shape, seq=True), mesh)
        q, k, v = (t.redistribute(mesh, place) if isinstance(t, DTensor)
                   else DTensor.from_local(t, mesh, [Replicate()] *
                                           len(names)).redistribute(
                                               mesh, place)
                   for t in (q, k, v))

        def local(ql, kl, vl):
            rank = mesh.get_local_rank("model")
            return sp_local(ql, gather_seq(kl), gather_seq(vl), rank,
                            causal=True, window=window)

        return local_map(local, out_placements=(place,),
                         in_placements=(place, place, place),
                         device_mesh=mesh)(q, k, v)

    return fn
