"""Multi-rank checks of the port's launch code, run as a script: spawns
4 CPU ranks (gloo) and prints one JSON line of results from rank 0.

    PYTHONPATH=src python tests/torch_dist_worker.py

* The sharded training step (``launch.train.train_sharded``) of each
  family's REDUCED config on a (2, 2) data × model mesh, 2 steps: each
  step's loss and whether every parameter kept its placements.
* Sequence-parallel prefill (``launch.spattn.build_sp_prefill``) on a
  (1, 4) mesh against one whole flash call, with and without a window:
  the largest output and q / k / v gradient differences, and the largest
  values they are held against.
* The sharded serve step (``launch.shardserve``) of SERVE_FAMILIES on
  the (2, 2) mesh — a prefill and three decode steps — against one
  device: each call's largest logit difference and largest logit.
* The same sharded serve of REDUCED llama4 on parameters in the card's
  layout (every packed weight, expert stacks included, in the A16 GEMM's
  fragment order, as ``quantize_params`` lays them out on a card): each
  call's largest logit difference against one device, the spec of an
  expert stack's data, and the experts run on the kernel's path and on
  the plain one.
* The expert-parallel ``moe_ffn`` (``launch.train._expert_parallel``) of
  REDUCED llama4 with ``big_model`` on the (2, 2) mesh against the plain
  call, under both dispatches: the output and gradient differences, the
  largest values, the gradients' placements against their parameters',
  and the number of experts each local call computed.
* The vocab-parallel loss (``launch.train._vocab_parallel_nll``) on the
  (2, 2) mesh, vocab 1023 (the last rank's shard one column short, one
  target in each rank's range and at both ends) against ``log_softmax``:
  the largest nll and logit-gradient differences.
* ``models.common.merge_heads`` on the (2, 2) mesh, its gradient coming
  back sharded on the merged dim over "model" (5 heads: not whole heads
  a rank): the input gradient's largest difference from the plain one.
"""
import dataclasses
import json
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the families of the sharded-step check: (arch, big_model)
FAMILIES = [("smollm-360m", False), ("llama4-scout-17b-a16e", True),
            ("rwkv6-7b", False), ("recurrentgemma-2b", False),
            ("whisper-tiny", False), ("internvl2-2b", False)]
BATCH, SEQ, STEPS = 4, 32, 2


def config(arch, big_model):
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, big_model=True) if big_model else cfg


def _placements(tree):
    from repro_torch.training.optimizer import leaf_groups
    return {k: [str(m.placements) for m in ms]
            for k, (_, ms) in leaf_groups(tree).items()}


def sharded_losses(mesh):
    from repro_torch.launch.sharding import ShardingRules, placements
    from repro_torch.launch.train import train_sharded
    from repro_torch.models.registry import build
    out = {}
    for arch, big in FAMILIES:
        cfg = config(arch, big)
        t0 = time.perf_counter()
        res = train_sharded(cfg, mesh, n_steps=STEPS, batch=BATCH, seq=SEQ,
                            lr=1e-3, device="cpu", verbose=False)
        want = ShardingRules(mesh, cfg).params(
            build(cfg).init_params(0, "cpu"))
        kept = _placements(res["params"]) == _spec_placements(want, mesh,
                                                              placements)
        out[arch] = {"losses": res["losses"], "placements_kept": kept,
                     "seconds": time.perf_counter() - t0}
    return out


def _spec_placements(specs, mesh, placements):
    """leaf_groups-shaped placements of a spec tree."""
    groups = {}

    def walk(node, path, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), stacked)
        elif isinstance(node, list):
            for v in node:
                walk(v, path, True)
        else:
            groups.setdefault("/".join(path), []).append(
                str(placements(node, mesh)))

    walk(specs, (), False)
    return groups


def sp_errors(mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core import attention as A
    from repro_torch.launch.spattn import build_sp_prefill
    g = torch.Generator().manual_seed(0)
    B, S, H, Hkv, D = 2, 1024, 4, 2, 64
    q, k, v = (torch.randn(B, S, h, D, generator=g).bfloat16()
               for h in (H, Hkv, Hkv))
    do = torch.randn(B, S, H, D, generator=g).bfloat16()
    sp = build_sp_prefill(mesh)
    rep = [Replicate()] * mesh.ndim
    out = {}
    for window in (None, 100):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = A.flash_attention(*leaves, window=window)
        ref.backward(do)
        dl = [distribute_tensor(t, mesh, rep).requires_grad_(True)
              for t in (q, k, v)]
        got = sp(*dl, causal=True, window=window)
        got.backward(distribute_tensor(do, mesh, got.placements))
        pairs = [(got.full_tensor(), ref)] + \
            [(d.grad.full_tensor(), leaf.grad) for d, leaf in zip(dl, leaves)]
        out[str(window)] = {
            "err": [(a.float() - b.float()).abs().max().item()
                    for a, b in pairs],
            "scale": [b.float().abs().max().item() for _, b in pairs],
            "rows_sharded": str(got.placements)}
    return out


def moe_errors(mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import train as T
    from repro_torch.launch.sharding import ShardingRules, placements
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import build
    cfg = config("llama4-scout-17b-a16e", True)
    rules = ShardingRules(mesh, cfg)
    params = build(cfg).init_params(0, "cpu")
    names = ("router", "we1", "we3", "we2")
    lp = {n: params["layers"][0][n] for n in names}
    specs = rules.params(params)["layers"][0]
    g = torch.Generator().manual_seed(1)
    x, dy = (torch.randn(BATCH, SEQ, cfg.d_model, generator=g).bfloat16()
             for _ in range(2))
    seen = []
    partial = MOE.moe_partial

    def spy(*args, experts=None, **kw):
        if experts is not None:         # the expert-parallel calls
            seen.append(len(experts))
        return partial(*args, experts=experts, **kw)

    out = {}
    MOE.moe_partial = spy
    try:
        for impl in ("einsum", "sort"):
            MOE.set_dispatch_impl(impl)
            seen.clear()
            leaves = {n: t.clone().requires_grad_(True) for n, t in lp.items()}
            xl = x.clone().requires_grad_(True)
            y = MOE.moe_ffn(xl, leaves, cfg)
            y.backward(dy)
            dl = {n: distribute_tensor(t, mesh, placements(specs[n], mesh))
                  .requires_grad_(True) for n, t in lp.items()}
            xd = distribute_tensor(x, mesh, placements(
                rules.tokens(x.shape), mesh)).requires_grad_(True)
            with T._sharded_hooks(rules):
                yd = MOE.moe_ffn(xd, dl, cfg)
                yd.backward(distribute_tensor(dy, mesh, yd.placements))
            pairs = [(yd, y), (xd.grad, xl.grad)] + \
                [(dl[n].grad, leaves[n].grad) for n in names]
            out[impl] = {
                "err": [(a.full_tensor().float() - b.float()).abs().max()
                        .item() for a, b in pairs],
                "scale": [b.float().abs().max().item() for _, b in pairs],
                "grads_placed": all(dl[n].grad.placements == dl[n].placements
                                    for n in names),
                "experts_a_call": sorted(set(seen))}
    finally:
        MOE.moe_partial = partial
        MOE.set_dispatch_impl("einsum")
    return out


#: the sharded serve step's families: (arch, big_model) — a dense config
#: whose KV heads divide the model axis (chatglm3: the cache sharded on
#: heads), one whose do not (smollm: on the sequence), moe and rwkv6
SERVE_FAMILIES = [("chatglm3-6b", False), ("smollm-360m", False),
                  ("llama4-scout-17b-a16e", True), ("rwkv6-7b", False)]
#: batch, prompt length, decode steps, slab length of the serve check
SERVE_B, SERVE_P, SERVE_STEPS, SERVE_S = 4, 14, 3, 32


def _card_layout(tree):
    """``tree`` with every packed weight, expert stacks included, in the
    A16 GEMM's fragment order: the layout ``quantize_params`` gives them
    on a card under w4a16kv8."""
    from repro_torch.core.packing import PackedWeight, to_kernel_layout
    if isinstance(tree, dict):
        return {k: _card_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_card_layout(v) for v in tree]
    if isinstance(tree, PackedWeight):
        return to_kernel_layout(tree, "a16")
    return tree


def _serve(cfg, rules=None, card_layout=False):
    """Prefill of SERVE_P tokens and SERVE_STEPS decode steps of a REDUCED
    config under w4a16kv8 from seeded parameters and tokens: single device
    (``rules`` None) or the sharded step on ``rules.mesh``
    (``launch.shardserve``); each call's logits, gathered.  With
    ``card_layout`` the packed weights are in the card's layout
    (:func:`_card_layout`)."""
    from repro_torch.core.precision import get_policy
    from repro_torch.launch import shardserve as SS
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    pol = get_policy("w4a16kv8")
    model = build(cfg)
    params = quantize_params(model.init_params(0, "cpu"), pol)
    if card_layout:
        params = _card_layout(params)
    cache = model.init_cache(pol, SERVE_B, SERVE_S, "cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), generator=gen,
                         dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab, (SERVE_STEPS, SERVE_B, 1),
                        generator=gen, dtype=torch.int32)
    extra = model.extra_inputs(7, SERVE_B, "cpu")
    pos = [torch.full((SERVE_B,), SERVE_P + cfg.n_img_tokens + i,
                      dtype=torch.int32) for i in range(SERVE_STEPS)]
    out = []
    if rules is None:
        with torch.no_grad():
            lg, cache = model.prefill(params, pol, toks, cache, **extra)
            out.append(lg)
            for i in range(SERVE_STEPS):
                lg, cache = model.decode_step(params, pol, nxt[i], cache,
                                              pos[i])
                out.append(lg)
        return out
    dp, dc, de = SS.place(model, params, pol, cache, rules, extra)
    with SS.serve_hooks(rules):
        lg, dc = SS.run(model.prefill, dp, pol, SS.tokens(toks, rules), dc,
                        **de)
        out.append(lg.full_tensor())
        for i in range(SERVE_STEPS):
            lg, dc = SS.run(model.decode_step, dp, pol,
                            SS.tokens(nxt[i], rules), dc,
                            SS.tokens(pos[i], rules))
            out.append(lg.full_tensor())
    return out


def serve_errors(mesh):
    """The sharded serve step of each of SERVE_FAMILIES on ``mesh``
    against one device: each call's largest logit difference, the largest
    logit, and where the slab's KV heads went."""
    from repro_torch.launch.sharding import ShardingRules
    out = {}
    for arch, big in SERVE_FAMILIES:
        cfg = config(arch, big)
        t0 = time.perf_counter()
        rules = ShardingRules(mesh, cfg)
        got, want = _serve(cfg, rules), _serve(cfg)
        spec = rules.cache_spec("k", (1, SERVE_B, SERVE_S, cfg.n_kv_heads,
                                      cfg.hd))
        out[arch] = {
            "err": [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)],
            "scale": [w.float().abs().max().item() for w in want],
            "kv_on_model": "heads" if spec[3] == "model" else
            ("sequence" if spec[2] == "model" else "none"),
            "seconds": time.perf_counter() - t0}
    return out


def card_layout_serve_errors(mesh):
    """The sharded serve step of REDUCED llama4 (``big_model``: FSDP on)
    on parameters in the card's layout against one device: each call's
    largest logit difference and the largest logit, the spec the rules
    give an expert stack's data in that layout and in the tile one, and
    the experts the sharded run took through the kernel's path and
    through the plain one."""
    from repro_torch import trace
    from repro_torch.core.precision import get_policy
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    cfg = config("llama4-scout-17b-a16e", True)
    rules = ShardingRules(mesh, cfg)
    c0 = trace.moe_experts_packed, trace.moe_experts_plain
    got = _serve(cfg, rules, card_layout=True)
    c1 = trace.moe_experts_packed, trace.moe_experts_plain
    want = _serve(cfg, card_layout=True)
    tile = quantize_params(build(cfg).init_params(0, "cpu"),
                           get_policy("w4a16kv8"))

    def stack_spec(params):
        return [list(e) if isinstance(e, tuple) else e
                for e in rules.params(params)["layers"][0]["we1"]["data"]]

    return {"err": [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)],
            "scale": [w.float().abs().max().item() for w in want],
            "stack_spec": stack_spec(_card_layout(tile)),
            "tile_stack_spec": stack_spec(tile),
            "experts_packed": c1[0] - c0[0],
            "experts_plain": c1[1] - c0[1]}


def nll_errors(mesh):
    """The vocab-parallel NLL and its logit gradient on ``mesh`` against
    ``log_softmax``'s, f32 logits (4, 6, 1023) from a seed."""
    import torch.nn.functional as F
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_reduced
    from repro_torch.launch.sharding import ShardingRules, placements
    from repro_torch.launch.train import _vocab_parallel_nll
    rules = ShardingRules(mesh, get_reduced("smollm-360m"))
    gen = torch.Generator().manual_seed(11)
    V = 1023
    logits = 4 * torch.randn((4, 6, V), generator=gen)
    tg = torch.randint(0, V, (4, 6), generator=gen)
    tg[0, :3] = torch.tensor([0, 511, 512])
    tg[1, :2] = torch.tensor([V - 1, 1000])
    want_lg = logits.clone().requires_grad_(True)
    want = -torch.gather(F.log_softmax(want_lg, -1), -1, tg[..., None])[..., 0]
    want.mean().backward()
    pl = placements(rules.tokens((4, 6)), mesh)
    lg = distribute_tensor(logits, mesh, pl).requires_grad_(True)
    got = _vocab_parallel_nll(rules)(lambda x: x, lg,
                                     distribute_tensor(tg, mesh, pl))
    got.mean().backward()
    return {"nll_err": (got.full_tensor() - want).abs().max().item(),
            "nll_scale": want.abs().max().item(),
            "grad_err": (lg.grad.full_tensor() - want_lg.grad).abs().max()
            .item(),
            "grad_scale": want_lg.grad.abs().max().item()}


def merge_heads_error(mesh):
    """``merge_heads`` of (4, 6, 5, 8) → (4, 6, 40) with its gradient put
    on (batch, merged dim over "model"): the input gradient against the
    plain reshape's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import common as C
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6, 5, 8), generator=gen)
    dy = torch.randn((4, 6, 40), generator=gen)
    dx = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    dx.requires_grad_(True)
    C.merge_heads(dx, 4, 6, -1).backward(
        distribute_tensor(dy, mesh, [Shard(0), Shard(2)]))
    return (dx.grad.full_tensor() - dy.reshape(4, 6, 5, 8)).abs().max() \
        .item()


def _rank(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), "cpu")
        res = {"sharded": sharded_losses(mesh), "moe": moe_errors(mesh),
               "sp": sp_errors(make_mesh((1, 4), "cpu")),
               "serve": serve_errors(mesh),
               "serve_card_layout": card_layout_serve_errors(mesh),
               "nll": nll_errors(mesh),
               "merge_heads": merge_heads_error(mesh)}
        if rank == 0:
            print("RESULT " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


def main():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(4, port), nprocs=4, join=True,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
