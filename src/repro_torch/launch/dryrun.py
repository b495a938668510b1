"""Multi-pod dry-run: prove the distribution config is coherent, on no card.

Port of ``repro.launch.dryrun``.  For every (architecture × input shape)
pair, build the real step (``train_step`` / ``prefill`` /
``decode_step``) on the production mesh — 16 × 16, or 2 × 16 × 16 with
``--multi-pod`` — with nothing allocated, run it sharded by
``launch.sharding.ShardingRules`` and record, per device, its count
(FLOPs, bytes and collective wire bytes by kind: ``roofline.op_cost``),
its memory and the three roofline terms on ``roofline.analysis.HW``.

How it runs with no card and no memory: one process holds rank 0 of a
fake process group of 256 (512) ranks (``torch.testing``'s ``FakeStore``,
backend ``"fake"``: collectives return at once) and a CPU ``DeviceMesh``
over it; every argument is a DTensor whose local shard is a fake tensor
(``FakeTensorMode``: shapes and dtypes, no storage) placed by the rules;
the kernel wrappers take shape-only implementations that declare the
wrappers' costs (``op_cost.rerouted``), the decode-attention cost reading
the host positions the dry-run sets (every slot at the cache's last
position, ``cache_len - 1``: the whole slab, as the reference's walk);
moe runs the static dispatch (``models.moe``: every expert of the rank on
its capacity buffer).  The step then runs once under an
``op_cost.OpCounter`` (rank 0's local ops and collectives) and a
``MemTracker`` (rank 0's allocations).

What differs from the reference, which lowers and compiles under pjit:

* **No HLO.**  ``lower_s`` is the seconds to build the step's abstract
  operands (parameters, packed weights, optimizer state, cache) and
  ``compile_s`` those of the counted run; ``--save-hlo`` is refused.
* **Rank 0 × chips.**  ``hlo_flops`` / ``hlo_bytes`` are rank 0's counts
  times the chips, as the reference scales its per-device HLO counts;
  the reference's SPMD program does the same masked work on every
  device, while the port's ranks differ where the layout is uneven
  (sequence-parallel prefill's causal walk: rank 0 has the least).
* **Kept pairs; ``block_skip`` and ``head_constraint`` are no-ops.**
  Attention counts the pairs the kernels keep: the kernels and their
  plain walk skip every key tile above the diagonal whatever the option
  (``core.attention._flash_triangle`` is that walk at the reference's
  blocks), so the count is the skipping count with or without
  ``block_skip``; the reference's halves with it.
* **Memory from the tracker.**  ``peak_bytes`` is the tracker's peak of
  rank 0's live tensors (arguments included), ``argument_bytes`` the
  local shard bytes of the parameters, optimizer state, cache and inputs,
  ``output_bytes`` those of the step's outputs (an in-place cache or
  parameter counted once, as an argument), ``temp_bytes`` = peak −
  arguments; the reference reads XLA's buffer assignment.
* The sharded step always constrains rwkv's heads to "model" where they
  divide it (``launch.train._sharded_hooks``), so ``head_constraint``
  changes nothing either.  Both options are accepted for the
  reference's CLI and set no state.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
    python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Tuple

DOC = __doc__

SERVING_POLICY = "w4a16kv8"      # paper headline format (§5.2)
TRAIN_POLICY = "w16a16kv16"      # paper is inference-only; training is bf16

# long_500k requires sub-quadratic attention: skipped for the pure
# full-attention archs; whisper's decoder is architecturally 448-max.
SKIPS: Dict[Tuple[str, str], str] = {
    ("arctic-480b", "long_500k"): "full attention; 500k KV would need "
        "block-sparse variant we don't claim",
    ("llama4-scout-17b-a16e", "long_500k"): "full attention",
    ("chatglm3-6b", "long_500k"): "full attention",
    ("internvl2-2b", "long_500k"): "full attention",
    ("smollm-360m", "long_500k"): "full attention",
    ("mistral-large-123b", "long_500k"): "full attention",
    ("whisper-tiny", "long_500k"): "decoder max context is "
        "architecturally 448; 500k decode not meaningful",
}

#: the production meshes' shapes
MESHES = {False: (16, 16), True: (2, 16, 16)}


def list_pairs():
    """Every (arch, shape, skip reason or None), in the reference's
    order."""
    from repro_torch.configs import ARCHS, SHAPES
    return [(a, s, SKIPS.get((a, s))) for a in ARCHS for s in SHAPES]


# ---------------------------------------------------------------------------
# Abstract operands
# ---------------------------------------------------------------------------

_FAKE = []


def fake_mode():
    """The process's ``FakeTensorMode`` (one, so abstract trees built for
    one pair serve the next)."""
    if not _FAKE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _FAKE[0]


@functools.lru_cache(maxsize=4)
def _abstract_params(cfg):
    """``cfg``'s parameters as fake tensors (no storage)."""
    from repro_torch.models.registry import build
    with fake_mode():
        return build(cfg).init_params(0, "cpu")


@functools.lru_cache(maxsize=4)
def _abstract_packed(cfg, policy_name: str):
    """``cfg``'s parameters packed for ``policy_name`` (the tile layout),
    as fake tensors."""
    from repro_torch.core.precision import get_policy
    from repro_torch.serving.engine import quantize_params
    with fake_mode():
        return quantize_params(_abstract_params(cfg), get_policy(policy_name))


def _shape(shape) -> Tuple[str, int, int, str]:
    """(name, seq, batch, kind) of a ``SHAPES`` name or a (seq, batch,
    kind) tuple."""
    from repro_torch.configs import SHAPES
    if isinstance(shape, str):
        return (shape,) + tuple(SHAPES[shape])
    seq, batch, kind = shape
    return f"{seq}x{batch}_{kind}", seq, batch, kind


def _meta(shape, dtype):
    import torch
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_lowerable(arch: str, shape, mesh,
                    serving_policy: str = SERVING_POLICY, cfg=None):
    """Returns ``(fn, args, specs, meta)``: the step, its abstract
    operands (fake or meta tensors: nothing allocated), their specs by
    ``ShardingRules`` on ``mesh`` (a ``DeviceMesh`` or any object with
    ``axis_names`` and a ``shape`` mapping) and the reference's meta keys
    (cfg, seq, batch, kind, policy) plus the rules and the decode
    positions the kernels' costs read (``host_pos``).  ``shape`` is a
    ``SHAPES`` name or a (seq, batch, kind) tuple; ``cfg`` replaces
    ``arch``'s configuration (both test seams)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import make_train_step, tree_map

    from .sharding import ShardingRules
    cfg = cfg or get_config(arch)
    model = build(cfg)
    _, seq, batch, kind = _shape(shape)
    serve_fsdp = "no_serve_fsdp" not in _OPTS
    rules = ShardingRules(mesh, cfg, fsdp=(kind == "train") or serve_fsdp)
    info = dict(cfg=cfg, seq=seq, batch=batch, kind=kind, rules=rules)

    if kind == "train":
        opt = O.for_config(cfg)
        with fake_mode():
            params = tree_map(lambda p: p.requires_grad_(True),
                              _abstract_params(cfg))
            opt_state = opt.init(params)
        step = make_train_step(model, opt, remat=True)

        def fn(params, opt_state, tokens, targets, extra):
            return step(params, opt_state, tokens, targets, **extra)

        toks = D.token_specs(batch, seq)
        extra = model.extra_specs(batch)
        args = (params, opt_state, toks["tokens"], toks["targets"], extra)
        specs = (rules.params(params), rules.opt_state(params, opt_state),
                 rules.tokens(toks["tokens"].shape),
                 rules.tokens(toks["targets"].shape),
                 rules.extra({k: tuple(v.shape) for k, v in extra.items()}))
        return fn, args, specs, dict(info, policy=TRAIN_POLICY)

    policy = get_policy(serving_policy)
    qparams = _abstract_packed(cfg, serving_policy)
    # VLMs prepend image-patch tokens to the text sequence: the cache
    # holds both
    cache_len = seq + cfg.n_img_tokens
    cache = model.cache_spec(policy, batch, cache_len)
    info = dict(info, policy=serving_policy, host_pos=cache_len - 1)

    if kind == "prefill":
        extra = model.extra_specs(batch)

        def fn(params, tokens, cache, extra):
            return model.prefill(params, policy, tokens, cache, **extra)

        tok = _meta((batch, seq), torch.int32)
        args = (qparams, tok, cache, extra)
        specs = (rules.params(qparams), rules.tokens(tok.shape),
                 rules.cache(cache),
                 rules.extra({k: tuple(v.shape) for k, v in extra.items()}))
        return fn, args, specs, info

    if kind != "decode":
        raise ValueError(f"unknown step kind {kind!r}")

    def fn(params, tokens, cache, pos):
        return model.decode_step(params, policy, tokens, cache, pos)

    tok = _meta((batch, 1), torch.int32)
    pos = _meta((batch,), torch.int32)
    args = (qparams, tok, cache, pos)
    specs = (rules.params(qparams), rules.tokens(tok.shape),
             rules.cache(cache), rules.tokens(pos.shape))
    return fn, args, specs, info


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------

_OPTS: list = []
#: the options ``--opt`` takes
OPTIONS = ("block_skip", "sp_attention", "head_constraint", "no_serve_fsdp")


def set_optimizations(names) -> None:
    """Enable beyond-paper options by name: ``sp_attention``
    (sequence-parallel prefill, ``launch.spattn``), ``no_serve_fsdp``
    (serve without FSDP weight shards), and ``block_skip`` and
    ``head_constraint``, which the port's step always does (see the module
    docstring) and so set nothing.  Mesh-dependent ones are applied per
    pair once the mesh exists (:func:`_apply_mesh_opts`)."""
    bad = [n for n in names if n not in OPTIONS]
    if bad:
        raise ValueError(f"unknown options {bad} (known: {OPTIONS})")
    _OPTS[:] = list(names)


def _apply_mesh_opts(mesh) -> None:
    from repro_torch.core import attention as A
    if "sp_attention" in _OPTS:
        from .spattn import build_sp_prefill
        A.set_sp_prefill(build_sp_prefill(mesh))
    else:
        A.set_sp_prefill(None)


@contextlib.contextmanager
def _restored():
    """Restore, after the block, what a pair sets: moe's dispatch,
    sequence-parallel prefill (test processes share them)."""
    from repro_torch.core import attention as A
    from repro_torch.models import moe as MOE
    saved = (MOE.dispatch_impl(), A.SP_PREFILL)
    try:
        yield
    finally:
        MOE.set_dispatch_impl(saved[0])
        A.set_sp_prefill(saved[1])


# ---------------------------------------------------------------------------
# The counted run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(shape):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake process group of its
    size, rank 0 (collectives return at once), destroyed after the block.
    Refuses to start over a live default process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_mesh
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own process group: a "
                           "default process group is already live")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, "cpu")
    finally:
        dist.destroy_process_group()


def _shape_only():
    """Each kernel wrapper's output (and lse) as empty tensors of its
    shapes: the dry-run's route (``op_cost.rerouted``)."""
    import torch

    def gemm(*args, **kw):
        return torch.empty((args[0].shape[0], args[-1].shape[1]),
                           dtype=torch.bfloat16, device=args[0].device)

    def attn(q, *args, **kw):
        if kw.get("return_lse") or (len(args) > 10 and args[10]):
            return (torch.empty_like(q, dtype=torch.float32),
                    torch.empty(q.shape[:3], dtype=torch.float32,
                                device=q.device))
        return torch.empty_like(q)

    def flash(q, k, v, **kw):
        out = torch.empty_like(q)
        if kw.get("return_lse"):
            return out, torch.empty(q.shape[:3], dtype=torch.float32,
                                    device=q.device)
        return out

    def flash_bwd(q, k, v, *args, **kw):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    return {"mpgemm_a16": gemm, "mpgemm_int8": gemm, "kvattn": attn,
            "paged_kvattn": attn, "flash_prefill": flash,
            "flash_prefill_bwd": flash_bwd}


def _leaves(tree):
    """Every tensor of ``tree``: dicts, lists, tuples, dataclasses
    (caches, PackedWeights)."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


def _locals(tree):
    """The local shard of every tensor of ``tree``."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in _leaves(tree)]


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def _storage(t):
    """An id of ``t``'s storage (an in-place output shares its
    argument's)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(t)


def count_step(fn, args, specs, info, mesh) -> Dict[str, Any]:
    """Run ``fn`` once on ``args`` placed by ``specs`` on ``mesh`` (fake
    local shards), its kernels shape-only, counted and memory-tracked:
    returns the counter's ``Cost``, the memory record and the seconds."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import cost as KC
    from repro_torch.models import moe as MOE
    from repro_torch.roofline import op_cost

    from .shardserve import serve_hooks
    from .sharding import abstract
    from .train import _sharded_hooks
    train = info["kind"] == "train"
    with fake_mode():
        dargs = abstract(args, specs, mesh)
        if train:
            from repro_torch.training.loop import tree_map
            dargs = (tree_map(lambda p: p.requires_grad_(True), dargs[0]),
                     ) + dargs[1:]
    arg_bytes = _local_bytes(dargs)
    costs = {}
    if "host_pos" in info:
        P = info["host_pos"]
        costs["kvattn"] = lambda *a, **k: KC.of_kvattn(
            *a, host_pos=[P] * a[0].shape[0], **k)
    hooks = _sharded_hooks if train else serve_hooks
    t0 = time.perf_counter()
    MOE.set_dispatch_impl("static")
    with fake_mode(), hooks(info["rules"]), \
            op_cost.rerouted(_shape_only(), costs), implicit_replication(), \
            torch.set_grad_enabled(train), op_cost.propagation_hidden():
        mt = MemTracker()
        mt.track_external(*_locals(dargs))
        with mt, op_cost.OpCounter() as counter:
            out = fn(*dargs)
        peak = sum(s.get("Total", 0)
                   for s in mt.get_tracker_snapshot("peak").values())
    seconds = time.perf_counter() - t0
    arg_store = {_storage(t) for t in _locals(dargs)}
    out_bytes = sum(t.numel() * t.element_size() for t in _locals(out)
                    if _storage(t) not in arg_store)
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(0, peak - arg_bytes), "peak_bytes": peak}
    return {"cost": counter.cost, "memory": memory, "seconds": seconds}


def run_pair(arch: str, shape, *, multi_pod: bool = False,
             serving_policy: str = SERVING_POLICY, mesh_shape=None,
             cfg=None) -> Dict[str, Any]:
    """Build and count one pair on the production mesh; returns the
    reference's record, and the torch version that counted it (``torch``:
    DTensor's choice of redistributions, and so the counts and the
    memory, differ between versions).  ``lower_s``: seconds to make the
    mesh and the step's abstract operands; ``compile_s``: seconds of the
    counted run.
    ``mesh_shape`` and ``cfg`` replace the production mesh and ``arch``'s
    configuration (test seams)."""
    import torch

    from repro_torch.roofline.analysis import analyze_sharded
    name = _shape(shape)[0]
    mshape = tuple(mesh_shape or MESHES[multi_pod])
    mesh_desc = "x".join(str(s) for s in mshape)
    skip = SKIPS.get((arch, name)) if cfg is None else None
    if skip:
        return {"arch": arch, "shape": name, "mesh": mesh_desc,
                "status": "skipped", "reason": skip,
                "torch": torch.__version__}
    t0 = time.perf_counter()
    with _restored(), fake_mesh(mshape) as mesh:
        _apply_mesh_opts(mesh)
        fn, args, specs, info = build_lowerable(
            arch, shape, mesh, serving_policy, cfg=cfg)
        t_lower = time.perf_counter() - t0
        run = count_step(fn, args, specs, info, mesh)
    terms = analyze_sharded(
        run["cost"], arch=arch, shape=name, mesh_desc=mesh_desc,
        chips=math.prod(mshape), cfg=info["cfg"], seq=info["seq"],
        batch=info["batch"], kind=info["kind"])
    return {
        "arch": arch, "shape": name, "mesh": mesh_desc,
        "status": "ok", "kind": info["kind"], "policy": info["policy"],
        "torch": torch.__version__,
        "lower_s": round(t_lower, 1), "compile_s": round(run["seconds"], 1),
        "memory": run["memory"],
        "roofline": terms.row(),
        "collective_bytes": {k: b for k, (_, b) in
                             run["cost"].collectives.items()},
        "device_counts": {"matmul_flops": run["cost"].matmul_flops,
                          "other_flops": run["cost"].other_flops,
                          "bytes": run["cost"].bytes},
    }


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: the port produces no HLO (it counts "
                     "the eager step's ops; see the module docstring)")


def main(argv=None) -> int:
    """The reference's CLI: one pair or ``--all``, JSONL records to
    ``--out``; exits 1 if any pair failed."""
    import torch

    from repro_torch.configs import ARCHS, SHAPES
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default=SERVING_POLICY)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--save-hlo", action=_Refuse, help=argparse.SUPPRESS)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip pairs already present in --out")
    ap.add_argument("--opt", default="",
                    help="comma-separated options: " + ", ".join(OPTIONS))
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.opt:
        set_optimizations([o.strip() for o in args.opt.split(",")])

    pairs = ([(args.arch, args.shape)] if not args.all
             else [(a, s) for a in ARCHS for s in SHAPES])
    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    mesh_desc = "2x16x16" if args.multi_pod else "16x16"
    fails = 0
    for arch, shape in pairs:
        if (arch, shape, mesh_desc) in done:
            print(f"[skip-done] {arch} × {shape} × {mesh_desc}")
            continue
        print(f"=== {arch} × {shape} × {mesh_desc} ===", flush=True)
        try:
            rec = run_pair(arch, shape, multi_pod=args.multi_pod,
                           serving_policy=args.policy)
        except Exception as e:      # noqa: BLE001 — record and continue
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_desc,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "torch": torch.__version__}
            fails += 1
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  build {rec['lower_s']}s  count {rec['compile_s']}s  "
                  f"flops {r['hlo_flops']:.3e}  bytes {r['hlo_bytes']:.3e}  "
                  f"coll/dev {r['coll_bytes_dev']:.3e}  "
                  f"dominant={r['dominant']}", flush=True)
            print(f"  memory: {rec['memory']}", flush=True)
        elif rec["status"] == "skipped":
            print(f"  SKIPPED: {rec['reason']}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

