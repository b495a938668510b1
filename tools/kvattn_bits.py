#!/usr/bin/env python3
"""Check that the decode-attention kernels of several trees of this
repository give the same bits on one card: the dense-slab kernel
(``kvattn``) and the paged one (``paged_kvattn``) at every shape of
``chip_smoke.py``'s attention phase (the serve shapes in all four KV
formats, the sub-tiled tiles, gemma3-1b's D 288, the moe and vlm heads),
on the seeded stores of ``chip_smoke.kv_stores``, called as the older
trees call them: no key offset, no lse.

    python3 tools/kvattn_bits.py OLD NEW [--out build/kvattn_bits.json]

Each TREE is a checkout of the repository (``.`` for this one) and runs in
a process of its own with its own ``src/`` on the path and its own
``build/`` directory; the shapes and the stores are this tree's.  Prints,
per shape and kernel, whether every tree's bytes equal the first tree's;
exits 1 if any differ.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def shapes():
    """(fmt, B, Hkv, rep, D, bs, bps, T, pos, window) of the attention
    phase."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    out = [(fmt, 4, 5, 3, 64, 16, 16, T, pos, None)
           for fmt in C.KV_FORMATS
           for T, pos in ((1, [95, 36, 70, 0]), (32, [32, 0, 64, 96]))]
    out += [tuple(s) + (None,) for s in C.SUB_TILES]
    out += [tuple(s) for s in C.D288_CASES]
    out += [tuple(s) + (None,) for s in C.MOE_VLM_ATTN]
    return out


def run_tree(cases) -> dict:
    """Digests of both kernels' outputs at ``cases`` with the wrappers on
    the path (one tree)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.core.paged_kvcache import blocks_needed
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    from repro_torch.kernels.ref import NO_WINDOW
    specs = {"kv8": "w4a16kv8", "kv4": "w4a8kv4", "kvfp8": "w8a8kvfp8",
             "kv16": "w16a16kv16"}
    dev = torch.device("cuda")
    out = {}
    for i, (fmt, B, Hkv, rep, D, bs, bps, T, pos, window) in enumerate(cases):
        spec = get_policy(specs[fmt]).kv
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + i)
        ctx = [p + T for p in pos]
        pool, slab = C.kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx)
        q = torch.randn((B, Hkv, T * rep, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        posd = torch.tensor(pos, dtype=torch.int32, device=dev)
        win = NO_WINDOW if window is None else window
        n_live = blocks_needed(max(ctx), bs)
        dense = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd,
                       win, rep, bs, spec)
        paged = paged_kvattn(q, pool.k, pool.k_scale, pool.v, pool.v_scale,
                             pool.block_table, posd, win, rep, n_live, spec)
        torch.cuda.synchronize()
        out[f"{i:02d} {fmt} B={B} Hkv={Hkv} rep={rep} D={D} bs={bs} T={T} "
            f"window={window}"] = {"kvattn": _digest(dense),
                                   "paged_kvattn": _digest(paged)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default="build/kvattn_bits.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # worker: shapes file
    args = ap.parse_args()
    if args.one:
        cases = json.loads(Path(args.one).read_text())
        print("DIGESTS " + json.dumps(run_tree(cases)), flush=True)
        return 0
    spec = Path(args.out).with_suffix(".shapes.json")
    spec.parent.mkdir(parents=True, exist_ok=True)
    spec.write_text(json.dumps(shapes()))
    runs = []
    for tree in args.trees:
        src = str(Path(tree).resolve() / "src")
        r = subprocess.run([sys.executable, __file__, "--one", str(spec)],
                           env=dict(os.environ, PYTHONPATH=src),
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:])
            return 1
        line = [x for x in r.stdout.splitlines()
                if x.startswith("DIGESTS ")][-1]
        runs.append(json.loads(line[len("DIGESTS "):]))
    same = {name: {k: all(run[name][k] == runs[0][name][k]
                          for run in runs[1:])
                   for k in runs[0][name]} for name in runs[0]}
    for name, row in same.items():
        print(f"{name:52s} " + "  ".join(
            f"{k} {'same' if v else 'DIFFERENT'}" for k, v in row.items()))
    ok = all(all(r.values()) for r in same.values())
    Path(args.out).write_text(json.dumps({"trees": args.trees, "same": same,
                                          "ok": ok}, indent=1))
    print("kvattn_bits:", "every output the same bits" if ok else
          "outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
