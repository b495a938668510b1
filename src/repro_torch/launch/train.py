"""Training entry point: one device, or a data × model mesh of ranks.

Port of ``repro.launch.train``: the same flags.  Trains the full
configuration on the card unless ``--reduced`` (the REDUCED config,
CPU-feasible) and ``--device cpu`` (tests).  ``--devices N`` (or
``--mesh``) spawns N ranks, one process each — gloo with ``--device
cpu``, NCCL with one card per rank on ``cuda`` — that build the mesh
(``--mesh "a,b"``, data × model; by default the reference's shape) and run
the sharded step (:func:`train_sharded`): parameters and optimizer state
are DTensors placed by ``launch.sharding.ShardingRules``, tokens are
sharded on the data axes, and the flash call runs the kernels on each
rank's shard (``core.attention``).  Rank 0 prints the reference's lines
and, with ``--checkpoint``, writes the reference's tree of the gathered
tensors.

Usage:
    python -m repro_torch.launch.train --arch smollm-360m --steps 100 \\
        --batch 8 --seq 128
    python -m repro_torch.launch.train --arch whisper-tiny --reduced \\
        --device cpu --steps 4 --seq 16
    python -m repro_torch.launch.train --device cpu --reduced --devices 4 \\
        --mesh 2,2 --steps 2
"""
import argparse
import contextlib
import dataclasses
import logging
import math
import socket
import sys
import time


def _mesh_shape(devices: int, mesh: str):
    """The mesh of ``--devices`` / ``--mesh``: the given shape (its size
    must be ``devices`` when both are set), or the reference's default
    (data × model, model = devices // 2)."""
    if mesh:
        shape = tuple(int(x) for x in mesh.split(","))
        if devices and math.prod(shape) != devices:
            raise ValueError(f"--mesh {mesh} has {math.prod(shape)} ranks, "
                             f"--devices {devices}")
        return shape
    dm = max(1, devices // 2) if devices > 1 else 1
    return (devices // dm, dm) if devices > 1 else (1, 1)


def _full(tree):
    """Every DTensor of ``tree`` gathered whole (collective: every rank
    calls it)."""
    from repro_torch.training.loop import tree_map
    return tree_map(lambda t: t.full_tensor()
                    if hasattr(t, "full_tensor") else t, tree)


def _head_constraint(rules):
    """Put the head axis of a (B, S, H, dh) DTensor on "model" where the
    rules do (H divides it); other tensors as they are."""
    from .sharding import placements

    def fn(x):
        spec = rules.activation(x.shape, heads=(x.shape[2],))
        if not hasattr(x, "placements") or spec[2] is None:
            return x
        return x.redistribute(rules.mesh, placements(spec, rules.mesh))

    return fn


def _flash_placements(rules):
    """Placements of flash attention's q, k and v: batch on the data axes,
    heads on "model" where both H and Hkv divide it."""
    from .sharding import placements
    return lambda q, k: placements(
        rules.activation(q.shape, heads=(q.shape[2], k.shape[2])),
        rules.mesh)


def _expert_parallel(rules):
    """``moe_ffn`` of DTensors: each rank runs the experts of its shard of
    E (``ShardingRules.experts``) on the tokens of its batch shard (the
    whole batch under the sort dispatch, whose capacity is the call's),
    through ``local_map``; the f32 sums of the ranks' experts are added
    over "model" and rounded once.  Gradients: x's summed over the
    expert ranks, the router's and the experts' over the batch ranks.
    Packed leaves (the serve step's expert stacks and router) go in as
    their data and scales, each placed as its stack."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.packing import PackedWeight
    from repro_torch.models import moe as MOE

    from .sharding import placements
    mesh = rules.mesh
    leaves = ("router", "we1", "we3", "we2")

    def parts(w):
        return (w.data, w.scales) if isinstance(w, PackedWeight) else (w,)

    def rebuild(lp, flat):
        out, i = {}, 0
        for n in leaves:
            w = lp[n]
            if isinstance(w, PackedWeight):
                out[n] = dataclasses.replace(w, data=flat[i],
                                             scales=flat[i + 1])
                i += 2
            else:
                out[n] = flat[i]
                i += 1
        return out

    def fn(x, lp, cfg, policy):
        x_pl = placements(rules.activation(
            x.shape, batch=MOE.rows_route_alone()), mesh)
        w_pl = placements(rules.experts(parts(lp["we1"])[0].shape), mesh)
        rep = (Replicate(),) * mesh.ndim
        by_rows = [isinstance(p, Shard) for p in x_pl]
        by_expert = [isinstance(p, Shard) for p in w_pl]
        # the output and x's gradient: partial sums over the expert ranks
        out_pl = tuple(Partial() if e else p
                       for p, e in zip(x_pl, by_expert))
        router_grad = tuple(Partial() if r or e else Replicate()
                            for r, e in zip(by_rows, by_expert))
        w_grad = tuple(Partial() if r else p for p, r in zip(w_pl, by_rows))
        e_dim = by_expert.index(True) if True in by_expert else None

        n_router = len(parts(lp["router"]))
        n_w = len(parts(lp["we1"]))

        def local(xl, *flat):
            lw = rebuild(lp, flat)
            n = parts(lw["we1"])[-1].shape[0]
            e0 = 0 if e_dim is None else mesh.get_coordinate()[e_dim] * n
            return MOE.moe_partial(xl, lw, cfg, policy,
                                   experts=range(e0, e0 + n)).float()

        args = [x.redistribute(mesh, x_pl)] + \
            [t.redistribute(mesh, rep) for t in parts(lp["router"])] + \
            [t.redistribute(mesh, w_pl) for n in leaves[1:]
             for t in parts(lp[n])]
        out = local_map(local, out_placements=(out_pl,),
                        in_placements=(x_pl,) + (rep,) * n_router +
                        (w_pl,) * (3 * n_w),
                        in_grad_placements=(out_pl,) +
                        (router_grad,) * n_router + (w_grad,) * (3 * n_w),
                        device_mesh=mesh)(*args)
        out = out.redistribute(mesh, x_pl).to(x.dtype)
        return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                       for p in x.placements])

    return fn


def _vocab_parallel_nll(rules):
    """The next-token NLL of (B, S, d) DTensor hidden states through
    ``logits_of`` (B, S, V), the vocabulary on "model" (the embedding's
    rule): through ``local_map`` each rank
    takes, over its vocab range, the rows' max, the sum of ``exp(logit -
    max)`` and the target's logit (0 where the target lies outside); the
    maxima are combined and the sums added over "model" (all-reduces of
    (B, S) rows), so no rank holds the whole vocabulary's logits.  f32, as
    ``Model.loss_fn``'s ``log_softmax``; the max is a constant of the
    gradient, as it is there."""
    import torch
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from .mesh import axis_names
    from .sharding import placements
    mesh = rules.mesh
    m = axis_names(mesh).index("model")
    n = mesh.size(m)

    def on_model(pl, p):
        return tuple(p if i == m else q for i, q in enumerate(pl))

    def fn(logits_of, h, targets):
        row = placements(rules.tokens(tuple(targets.shape)), mesh)
        lg_pl = on_model(row, Shard(2))
        logits = logits_of(h).redistribute(mesh, lg_pl)
        targets = targets.redistribute(mesh, row)
        chunk = -(-logits.shape[-1] // n)         # Shard's (ceil) split

        def local_max(lg):
            return lg.detach().float().amax(-1)

        def local_sums(lg, tg, top):
            lg = lg.float()
            t = tg.long() - mesh.get_local_rank("model") * chunk
            inside = (t >= 0) & (t < lg.shape[-1])
            tl = torch.gather(lg, -1, t.clamp(0, lg.shape[-1] - 1)[..., None])
            return (torch.exp(lg - top[..., None]).sum(-1),
                    torch.where(inside, tl[..., 0], torch.zeros_like(top)))

        top = local_map(local_max, out_placements=(on_model(row, Partial(
            "max")),), in_placements=(lg_pl,), device_mesh=mesh)(logits)
        top = top.redistribute(mesh, row)
        sums = on_model(row, Partial())
        se, tl = local_map(local_sums, out_placements=(sums, sums),
                           in_placements=(lg_pl, row, row),
                           device_mesh=mesh)(logits, targets, top)
        se, tl = (t.redistribute(mesh, row) for t in (se, tl))
        return torch.log(se) + top - tl

    return fn


@contextlib.contextmanager
def _sharded_hooks(rules):
    """Install, for the block, the model's DTensor hooks from ``rules``:
    rwkv's head constraint, flash attention's operand placements, moe's
    expert parallelism and, where "model" splits the vocabulary, the
    vocab-parallel loss."""
    from repro_torch.core import attention as A
    from repro_torch.models import common as C
    from repro_torch.models import moe as MOE
    from repro_torch.models import registry as REG
    C.set_head_constraint(_head_constraint(rules))
    A.set_flash_placements(_flash_placements(rules))
    MOE.set_sharded_ffn(_expert_parallel(rules))
    if rules.model_size > 1:
        REG.set_sharded_nll(_vocab_parallel_nll(rules))
    try:
        yield
    finally:
        C.set_head_constraint(None)
        A.set_flash_placements(None)
        MOE.set_sharded_ffn(None)
        REG.set_sharded_nll(None)


def train_sharded(cfg, mesh, n_steps: int = 100, batch: int = 8,
                  seq: int = 128, lr: float = 3e-4, seed: int = 0,
                  log_every: int = 10, remat: bool = False,
                  checkpoint_path=None, device="cuda",
                  verbose: bool = True):
    """The sharded training loop on ``mesh`` (every rank of its process
    group calls it): ``loop.train``'s parameters, optimizer and data,
    placed by :class:`launch.sharding.ShardingRules`, with the model's
    DTensor hooks installed for the run (:func:`_sharded_hooks`).
    Returns the parameters and optimizer state (DTensors), each step's
    loss (gathered, on every rank) and wall seconds (host clock, ending
    in the loss's gather), the run's wall seconds and tokens per
    second."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.registry import build
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import (empty_state, make_train_step,
                                           tree_map)

    from .sharding import ShardingRules, distribute

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    model = build(cfg)
    rules = ShardingRules(mesh, cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      model.init_params(seed, device))
    opt = O.for_config(cfg, lr=lr, total_steps=n_steps)
    state = opt.init(params)
    opt_state = distribute(state, rules.opt_state(params, state), mesh)
    params = distribute(params, rules.params(params), mesh)
    extra = model.extra_inputs(seed + 7, batch, device)
    extra = distribute(extra, rules.extra(
        {k: tuple(v.shape) for k, v in extra.items()}), mesh)
    step_fn = make_train_step(model, opt, remat=remat)
    cuda = torch.device(device).type == "cuda"
    losses, step_s = [], []
    with _sharded_hooks(rules):
        t0 = time.perf_counter()
        for i, (toks, tgts) in enumerate(
                D.batches(cfg.vocab, batch, seq, n_steps, seed, device)):
            ts = time.perf_counter()
            spec = rules.tokens(tuple(toks.shape))
            toks, tgts = (distribute(t, spec, mesh) for t in (toks, tgts))
            with implicit_replication():
                params, opt_state, loss = step_fn(params, opt_state, toks,
                                                  tgts, **extra)
            lv = float(_full(loss))
            if cuda:
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - ts)
            losses.append(lv)
            if verbose and (i % log_every == 0 or i == n_steps - 1):
                print(f"step {i:5d}  loss {lv:.4f}", flush=True)
        dt = time.perf_counter() - t0
    if checkpoint_path:
        state = _full({"params": params, "opt": opt_state})
        if torch.distributed.get_rank() == 0:
            CKPT.save(checkpoint_path, state, step=n_steps,
                      empty=empty_state(model, opt))
        torch.distributed.barrier()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_s": step_s, "wall_s": dt,
            "tokens_per_s": n_steps * batch * seq / dt}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, shape, args) -> None:
    """One rank of ``--devices``: its process group and mesh, then
    :func:`train_sharded`."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_reduced

    from .mesh import make_mesh

    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
        device = "cpu"
    else:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(shape, "cpu" if cpu else "cuda")
        cfg = get_reduced(args.arch) if args.reduced else \
            get_config(args.arch)
        lead = rank == 0
        if lead:
            print(f"mesh {dict(zip(mesh.mesh_dim_names, shape))}, "
                  f"arch {cfg.name}", flush=True)
        res = train_sharded(cfg, mesh, n_steps=args.steps, batch=args.batch,
                            seq=args.seq, lr=args.lr, log_every=10,
                            remat=args.remat,
                            checkpoint_path=args.checkpoint or None,
                            device=device, verbose=lead)
        if lead:
            print(f"done: {args.steps} steps, "
                  f"{res['tokens_per_s']:.0f} tokens/s", flush=True)
            if args.checkpoint:
                print("checkpoint:", args.checkpoint, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    """Train ``--steps`` steps on the synthetic corpus; print the losses,
    tokens/s and, with ``--checkpoint``, where the checkpoint went."""
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-feasible)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to spawn (gloo on --device cpu, one card "
                    "each on cuda); 0 = one device, in this process")
    ap.add_argument("--mesh", default="", help='e.g. "2,2" = data×model')
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.devices or args.mesh:
        import torch.multiprocessing as mp
        shape = _mesh_shape(args.devices, args.mesh)
        world = math.prod(shape)
        if args.device != "cpu":
            import torch
            if torch.cuda.device_count() < world:
                raise RuntimeError(f"{world} ranks need {world} cards "
                                   "(one each); found "
                                   f"{torch.cuda.device_count()}")
        mp.start_processes(_rank, args=(world, _free_port(), shape, args),
                           nprocs=world, join=True, start_method="spawn")
        return 0

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.training.loop import train

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"device {args.device}, arch {cfg.name}")
    res = train(cfg, n_steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, log_every=10, remat=args.remat,
                checkpoint_path=args.checkpoint or None,
                checkpoint_every=args.steps if args.checkpoint else 0,
                device=args.device)
    print(f"done: {args.steps} steps, {res['tokens_per_s']:.0f} tokens/s")
    if args.checkpoint:
        print("checkpoint:", args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
