"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moment).

Port of ``repro.training.optimizer``: (init, update) pairs over the
port's parameter dicts, updating the parameters in place under
``torch.no_grad`` in f32 and casting back to each parameter's dtype.
Adafactor is the choice for the configs with ``big_model`` set
(mistral-large-123b, llama4-scout-17b-a16e, arctic-480b): its factored
second moment keeps ~4 B/param of state where AdamW keeps 12.

**Stacked leaves.**  The reference's optimizers see each layer stack as
one leaf with a leading axis L (a moe layer's experts as (L, E, d, f)),
and that changes the update in three places: AdamW decays every leaf of
two or more dims, so a stacked norm gain (L, d) is decayed (a top-level
``final_norm`` is not); Adafactor factors the trailing two dims, so a
stacked gain gets ``vr`` (L,) and ``vc`` (d,) — a ``vc`` shared by the
layers — rather than an unfactored ``v``; and Adafactor's ``rms_u`` and
``scale`` are means over the whole stacked leaf, across layers.  The port
keeps per-layer lists (``convert.params_from_jax``), so the update
gathers each stack's members into one (L, ...) f32 tensor
(:func:`leaf_groups`), applies the reference's arithmetic to it and
writes the rows back.  The state holds one stacked tensor per group,
keyed by its path (``"layers/wq"``, ``"encoder/ln1/g"``, ``"embed"``).

**DTensors** (the sharded step, ``launch/train.py``).  The same code runs
on DTensor parameters, gradients and state: each gradient is first put on
its parameter's placements (a replicated parameter's gradient arrives
``Partial`` over the data axes and is summed there), an updated row is put
back on its member's placements before the copy, and new state on the
placements of the state it replaces (:func:`_placed`), so every leaf
keeps its sharding across steps.  On plain tensors these are no-ops.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (params, state)``, the parameters updated in place."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


Group = Tuple[bool, List[torch.Tensor]]


def leaf_groups(tree) -> Dict[str, Group]:
    """The reference's leaves of a parameter (or gradient) dict: path →
    (stacked, members).  Every list in the tree is a layer stack: each
    leaf path under it is one group whose members are the layers' tensors
    in order (stacked: the reference holds them as one (L, ...) leaf);
    any other tensor is a group of one (not stacked)."""
    groups: Dict[str, Group] = {}

    def walk(node, path, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), stacked)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, path, True)
        else:
            groups.setdefault("/".join(path), (stacked, []))[1].append(node)

    walk(tree, (), False)
    return groups


def _gather(group: Group) -> torch.Tensor:
    """A group as one f32 tensor: (L, ...) for a stack."""
    stacked, members = group
    if stacked:
        return torch.stack([m.detach().float() for m in members])
    return members[0].detach().float()


def _placed(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on the placements of ``like`` where both are DTensors (a
    ``Partial`` sum reduced, a shard cut or gathered), else ``t``."""
    placements = getattr(like, "placements", None)
    if placements is None or getattr(t, "placements", None) == placements:
        return t
    return t.redistribute(like.device_mesh, placements)


def _scatter(group: Group, new: torch.Tensor) -> None:
    """Write an updated f32 group back into its members (cast to each
    member's dtype, rounding to nearest)."""
    stacked, members = group
    if stacked:
        placements = getattr(members[0], "placements", None)
        if placements is not None:     # the members' shards, one dim in
            from torch.distributed.tensor import Shard
            new = new.redistribute(members[0].device_mesh, [
                Shard(p.dim + 1) if isinstance(p, Shard) else p
                for p in placements])
        for m, row in zip(members, new.unbind(0)):
            m.copy_(_placed(row, m))
    else:
        members[0].copy_(_placed(new, members[0]))


def _stacked_shape(group: Group) -> Tuple[int, ...]:
    stacked, members = group
    return ((len(members),) if stacked else ()) + tuple(members[0].shape)


def _grads(grads, params) -> Dict[str, torch.Tensor]:
    """Each group's gradient as one f32 tensor (zeros where a member got
    none, e.g. an expert no token reached), on its parameters'
    placements."""
    pg = leaf_groups(params)
    out = {}
    for name, (stacked, members) in leaf_groups(grads).items():
        members = [torch.zeros_like(p) if g is None else _placed(g, p)
                   for g, p in zip(members, pg[name][1])]
        out[name] = _gather((stacked, members))
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup: int = 100, total_steps: int = 10_000) -> Optimizer:
    """AdamW with linear warmup and a cosine schedule floored at 0.1 of
    ``lr``; decoupled weight decay on leaves of two or more dims."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total_steps - warmup),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return lr * torch.clamp(warm, max=1.0) * torch.clamp(cos, min=0.1)

    def init(params):
        groups = leaf_groups(params)
        dev = next(iter(groups.values()))[1][0].device
        zeros = {n: torch.zeros(_stacked_shape(g), dtype=torch.float32,
                                device=dev) for n, g in groups.items()}
        return {"mu": zeros,
                "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = schedule(step)
        bc1 = 1.0 - torch.pow(b1, step.float())
        bc2 = 1.0 - torch.pow(b2, step.float())
        gs = _grads(grads, params)
        mu, nu = {}, {}
        for name, group in leaf_groups(params).items():
            g = gs[name]
            mu[name] = _placed(b1 * state["mu"][name] + (1 - b1) * g,
                               state["mu"][name])
            nu[name] = _placed(b2 * state["nu"][name] + (1 - b2) * g * g,
                               state["nu"][name])
            p = _gather(group)
            upd = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + eps)
            if p.dim() >= 2:    # decoupled weight decay on matrices only
                upd = upd + weight_decay * p
            _scatter(group, p - lr_t * upd)
        return params, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moment, no first moment
# ---------------------------------------------------------------------------


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps1: float = 1e-30,
              eps2: float = 1e-3, clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor: the second moment factored over the two trailing dims of
    a leaf of two or more dims (leading dims — layer and expert stacks —
    kept), update clipping at ``clip_threshold`` RMS, relative step
    ``lr · max(eps2, rms(p))``."""
    def init(params):
        groups = leaf_groups(params)
        dev = next(iter(groups.values()))[1][0].device

        def per(shape):
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          device=dev)}
            return {"v": torch.zeros(shape, device=dev)}

        return {"m": {n: per(_stacked_shape(g)) for n, g in groups.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - (step.float() + 1.0) ** (-decay)
        gs = _grads(grads, params)
        m = {}
        for name, group in leaf_groups(params).items():
            g, s = gs[name], state["m"][name]
            p = _gather(group)
            g2 = g * g + eps1
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True)
                u = g / (torch.sqrt(vr / torch.clamp_min(denom, eps1))[
                    ..., None] * torch.sqrt(vc)[..., None, :] + eps1)
                m[name] = {"vr": _placed(vr, s["vr"]),
                           "vc": _placed(vc, s["vc"])}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(v) + eps1)
                m[name] = {"v": _placed(v, s["v"])}
            rms_u = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            scale = torch.clamp_min(torch.sqrt(torch.mean(p * p)), eps2)
            _scatter(group, p - lr * scale * u)
        return params, {"m": m, "step": step}

    return Optimizer(init=init, update=update)


def for_config(cfg, lr: float = 3e-4, **kw) -> Optimizer:
    """Paper-scale default: adafactor for big_model archs, adamw
    otherwise."""
    if getattr(cfg, "big_model", False):
        return adafactor(lr=lr)
    return adamw(lr=lr, **kw)
