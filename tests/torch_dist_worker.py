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
* The expert-parallel ``moe_ffn`` (``launch.train._expert_parallel``) of
  REDUCED llama4 with ``big_model`` on the (2, 2) mesh against the plain
  call, under both dispatches: the output and gradient differences, the
  largest values, the gradients' placements against their parameters',
  and the number of experts each local call computed.
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


def _rank(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), "cpu")
        res = {"sharded": sharded_losses(mesh), "moe": moe_errors(mesh),
               "sp": sp_errors(make_mesh((1, 4), "cpu"))}
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
