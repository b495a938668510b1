"""The sharded serve step: ``prefill`` and ``decode_step`` of every family on
DTensor parameters and caches placed by ``launch.sharding.ShardingRules``.

The model code is the single-device code; where it meets a DTensor that
the kernels cannot take, hooks installed for the block
(:func:`serve_hooks`, as ``launch.train._sharded_hooks`` for training)
take the call and run the kernels on each rank's local shards:

* **Packed GEMMs** (``models.common.linear`` of a PackedWeight whose
  tensors are DTensors): the weight's data-axis (FSDP) shards — K units
  or whole 16-column fragment blocks (``ShardingRules.frag_spec``) — are
  gathered, its "model" shard stays; each rank multiplies its local x by
  its local weight through ``local_map``.  Column-parallel (N on
  "model") gives an output sharded on its last dim; row-parallel (K on
  "model") a partial sum, reduced over "model" (an all-reduce).
* **Decode attention** (``models.common.attend_decode`` over a slab of
  DTensors): a slab sharded on heads runs the kernel on each rank's
  heads; a slab sharded on the sequence (every KV head count of the
  catalog on a 16-way model axis) runs the kernel on each rank's key
  range at its key offset with the log-sum-exp and an unrounded f32
  output, and the ranks' partial outputs are combined over "model" by
  their lse in f32 (an all-reduce of the max, one of the weighted sums)
  and rounded once.
* **Cache writes** (``core.kvcache.append`` / ``append_per_slot`` into a
  slab of DTensors): a head-sharded slab takes each rank's heads of the
  update; on a sequence-sharded slab only the rank whose key range holds
  a position writes it (a prefill's rows by slicing, a decode token by a
  static select that writes back the old row elsewhere: no host read).
* **Embedding lookups** in a vocab-sharded table outside autograd: each
  rank looks up the tokens of its vocab range, the rows summed over
  "model".
* moe's expert parallelism (``launch.train._expert_parallel``, packed
  expert stacks included), flash attention's placements and rwkv's head
  constraint, as in training.

One-shot families' states (rglru's h / conv, rwkv6's shifts and wkv,
whisper's cross cache) are DTensors placed by ``ShardingRules.cache`` and
updated by the model's own tensor ops.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .mesh import axis_names


def _model_dim(mesh) -> int:
    return axis_names(mesh).index("model")


def _only_model(pl, mesh):
    """``pl`` with every data-axis placement replicated (FSDP shards
    gathered), the "model" one kept."""
    from torch.distributed.tensor import Replicate
    m = _model_dim(mesh)
    return tuple(p if i == m else Replicate() for i, p in enumerate(pl))


def _no_partial(pl):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in pl)


def _as_dtensor(t, mesh):
    """``t`` as a DTensor (a plain tensor is taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _with_model(pl, mesh, p):
    """``pl`` with its "model" placement set to ``p``."""
    m = _model_dim(mesh)
    return tuple(p if i == m else q for i, q in enumerate(pl))


def sharded_linear(x, w, policy):
    """``x @ W`` for a PackedWeight whose data and scales are DTensors
    (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.gemm import mp_matmul
    from repro_torch.core.packing import PackedWeight
    if not isinstance(w, PackedWeight):
        return _dense_linear(x, w)
    mesh = w.data.device_mesh
    k_dim, n_dim = (0, 1) if w.layout == "tile" else (1, 0)
    on_model = w.data.placements[_model_dim(mesh)]
    row = isinstance(on_model, Shard) and on_model.dim == k_dim
    column = isinstance(on_model, Shard) and on_model.dim == n_dim
    d_pl = _only_model(w.data.placements, mesh)
    # the scales (K / group, N) follow the data's split (the rules may
    # split N's scales where the tile grid does not divide)
    s_pl = _with_model(d_pl, mesh, Shard(0) if row else
                       (Shard(1) if column else Replicate()))
    x = _as_dtensor(x, mesh)
    x_pl = _with_model(_no_partial(x.placements), mesh,
                       Shard(x.ndim - 1) if row else Replicate())
    out_model = Partial() if row else \
        (Shard(x.ndim - 1) if column else Replicate())
    out_pl = _with_model(x_pl, mesh, out_model)
    unit = (w.block_k, w.block_n) if w.layout == "tile" else (64, 16)

    def local(xl, dl, sl):
        shape = (dl.shape[k_dim] * unit[0], dl.shape[n_dim] * unit[1])
        wl = dataclasses.replace(w, data=dl, scales=sl, shape=shape)
        return mp_matmul(xl, wl, policy)

    out = local_map(local, out_placements=(out_pl,),
                    in_placements=(x_pl, d_pl, s_pl), device_mesh=mesh)(
        x.redistribute(mesh, x_pl), w.data.redistribute(mesh, d_pl),
        w.scales.redistribute(mesh, s_pl))
    return out.redistribute(mesh, _no_partial(out_pl)) if row else out


def _dense_linear(x, w):
    """``x @ w`` of a DTensor x and a bf16 weight: x's last dim gathered
    where it is sharded and the weight's K is not on that mesh dim, so the
    contraction runs whole on each rank (a bf16 product of a split
    contraction would be summed over ranks in bf16)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    w = _as_dtensor(w, mesh)
    k_dim = w.ndim - 2
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
               and not (isinstance(q, Shard) and q.dim == k_dim) else p
               for p, q in zip(x.placements, w.placements))
    return torch.matmul(x.redistribute(mesh, _no_partial(pl)),
                        w.to(x.dtype))


def _local_rows(pos, mesh, pl):
    """``pos`` (B,) as the local rows of a (B, ...) tensor placed ``pl``
    (its batch placement), as a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard
    pos = _as_dtensor(torch.as_tensor(pos) if not hasattr(pos, "placements")
                      else pos, mesh)
    want = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 and
                 i != _model_dim(mesh) else Replicate()
                 for i, p in enumerate(pl))
    return pos.redistribute(mesh, want).to_local()


def sharded_decode(q, cache_l, spec, pos, window, block_s):
    """Decode attention over a per-layer slab of DTensors (module
    docstring).  q (B, T, H, D); pos (B,) each slot's first position."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.kvcache import KVCache
    from repro_torch.kernels import ops
    mesh = cache_l.k.device_mesh
    m = _model_dim(mesh)
    kv_model = cache_l.k.placements[m]
    heads = isinstance(kv_model, Shard) and kv_model.dim == 2
    seq = isinstance(kv_model, Shard) and kv_model.dim == 1
    q = _as_dtensor(q, mesh)
    batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in cache_l.k.placements)
    q_pl = _with_model(batch, mesh, Shard(2) if heads else Replicate())
    ql = q.redistribute(mesh, q_pl).to_local()
    posl = _local_rows(pos, mesh, batch)
    local = KVCache(*(t.to_local() for t in (cache_l.k, cache_l.v,
                                             cache_l.k_scale,
                                             cache_l.v_scale)))
    if not seq:
        out = ops.kvattn_decode(ql, local, spec, posl, window, block_s)
    else:
        key0 = mesh.get_local_rank("model") * local.k.shape[1]
        out, lse = ops.kvattn_decode(ql, local, spec, posl, window, block_s,
                                     key_offset=key0, return_lse=True)
        group = (mesh, m)
        top = fc.all_reduce(lse, "max", group).clamp_min(-1e30)
        w = torch.exp(lse - top)                          # (B, T, H)
        part = torch.cat([w[..., None] * out, w[..., None]], -1)
        tot = fc.all_reduce(part, "sum", group)
        out = (tot[..., :-1] / tot[..., -1:].clamp_min(1e-20)).to(ql.dtype)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def sharded_append(cache_l, k_new, v_new, pos, spec, valid=None):
    """Write a (B, T) update into a per-layer slab of DTensors, in place
    (module docstring).  ``pos`` an int (every slot, a prefill's 0) or
    (B,) per-slot positions (a decode step: T must be 1 on a
    sequence-sharded slab)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core import kvcache as KV
    mesh = cache_l.k.device_mesh
    kv_model = cache_l.k.placements[_model_dim(mesh)]
    seq = isinstance(kv_model, Shard) and kv_model.dim == 1
    batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in cache_l.k.placements)
    new_pl = _with_model(batch, mesh, Replicate() if seq else kv_model)
    kl, vl = (_as_dtensor(t, mesh).redistribute(mesh, new_pl).to_local()
              for t in (k_new, v_new))
    local = KV.KVCache(*(t.to_local() for t in (cache_l.k, cache_l.v,
                                                cache_l.k_scale,
                                                cache_l.v_scale)))
    per_slot = not isinstance(pos, int)
    Sl = local.max_seq
    key0 = mesh.get_local_rank("model") * Sl if seq else 0
    if not per_slot:                    # rows [pos, pos + T) of the update
        T = kl.shape[1]
        lo, hi = max(key0, pos), min(key0 + Sl, pos + T)
        if lo < hi:
            rows = slice(lo - pos, hi - pos)
            KV.append(local, kl[:, rows], vl[:, rows], lo - key0, spec)
        return
    if kl.shape[1] == 1 and valid is None:
        _write_token(local, kl, vl, _local_rows(pos, mesh, batch).long(),
                     key0, spec)
    elif not seq:                       # a chunk: reads its row mask back
        KV.append_per_slot(local, kl, vl, _local_rows(pos, mesh, batch).int(),
                           spec, None if valid is None else
                           _local_rows(valid, mesh, batch))
    else:
        raise ValueError("a sequence-sharded slab takes one token a slot "
                         "per decode step")


def _write_token(local, kl, vl, pos, key0: int, spec) -> None:
    """Quantize one token a slot (kl / vl (B, 1, H, D)) and write slot b's
    at position ``pos[b]`` of a local slab holding positions ``key0`` on,
    in place, where the slab holds it: every row is read at its clamped
    target and written back with the new value only where owned — static
    shapes, no host read."""
    from repro_torch.core import quantize as Q
    B, Sl = pos.shape[0], local.max_seq
    rel = pos - key0
    own = (rel >= 0) & (rel < Sl)
    dst = torch.arange(B, device=pos.device) * Sl + rel.clamp(0, Sl - 1)
    qv, sc = Q.quantize_kv(torch.stack([kl, vl]), spec)
    H = kl.shape[2]
    qv = qv.reshape(2, B, H, qv.shape[-1])
    sc = sc.reshape(2, B, H)
    if qv.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        qv = qv.view(torch.uint8)
    for buf, val in ((local.k, qv[0]), (local.v, qv[1]),
                     (local.k_scale, sc[0]), (local.v_scale, sc[1])):
        flat = buf.view(val.dtype).view((-1,) + tuple(buf.shape[2:]))
        keep = own.view((B,) + (1,) * (val.dim() - 1))
        flat.index_copy_(0, dst, torch.where(keep, val,
                                             flat.index_select(0, dst)))


def sharded_embed(table, tokens):
    """Rows ``table[tokens]`` of a DTensor table outside autograd: a
    vocab-sharded table's rows looked up where each rank holds them and
    summed over "model"; any other table gathered whole first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    m = _model_dim(mesh)
    on_model = table.placements[m]
    tokens = _as_dtensor(tokens, mesh)
    t_pl = _with_model(_no_partial(tokens.placements), mesh, Replicate())
    tokens = tokens.redistribute(mesh, t_pl)
    if not (isinstance(on_model, Shard) and on_model.dim == 0):
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        return torch.nn.functional.embedding(tokens.long(), whole)
    tab_pl = _with_model((Replicate(),) * mesh.ndim, mesh, Shard(0))
    out_pl = _with_model(t_pl, mesh, Partial())

    def local(tl, wl):
        V = wl.shape[0]
        idx = tl.long() - mesh.get_local_rank("model") * V
        hit = (idx >= 0) & (idx < V)
        rows = wl[idx.clamp(0, V - 1)]
        return torch.where(hit[..., None], rows, torch.zeros_like(rows))

    out = local_map(local, out_placements=(out_pl,),
                    in_placements=(t_pl, tab_pl), device_mesh=mesh)(
        tokens, table.redistribute(mesh, tab_pl))
    return out.redistribute(mesh, _no_partial(out_pl))


@contextlib.contextmanager
def serve_hooks(rules):
    """Install, for the block, the sharded serve step's hooks (module
    docstring) beside the training step's (``launch.train``)."""
    from repro_torch.core import kvcache as KV
    from repro_torch.models import common as C

    from .train import _sharded_hooks
    with _sharded_hooks(rules):
        C.set_sharded_serve(linear=sharded_linear, decode=sharded_decode,
                            embed=sharded_embed)
        KV.set_sharded_append(sharded_append)
        try:
            yield
        finally:
            C.set_sharded_serve()
            KV.set_sharded_append(None)


def place(model, params, policy, cache, rules, extra=None):
    """The serve step's operands on ``rules.mesh``: packed parameters and
    the cache as DTensors by ``rules.params`` / ``rules.cache`` (each rank
    keeps its shard of the whole tensors it holds), extra inputs by
    ``rules.extra``."""
    from .sharding import distribute
    mesh = rules.mesh
    out = [distribute(params, rules.params(params), mesh),
           distribute(cache, rules.cache(cache), mesh)]
    if extra is not None:
        out.append(distribute(extra, rules.extra(
            {k: tuple(v.shape) for k, v in extra.items()}), mesh))
    return out


def run(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of the sharded step: no autograd, plain
    tensors the model makes taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication():
        return fn(*args, **kwargs)


def tokens(t, rules):
    """(B, ...) tokens or positions as a DTensor by ``rules.tokens``."""
    from .sharding import distribute
    return distribute(t, rules.tokens(tuple(t.shape)), rules.mesh)


__all__ = ["serve_hooks", "place", "run", "tokens", "sharded_linear",
           "sharded_decode", "sharded_append", "sharded_embed"]
