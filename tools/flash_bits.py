#!/usr/bin/env python3
"""Check that the flash kernels of several trees of this repository give
the same bits on one card: the forward (with and without the lse) at
``chip_smoke.FLASH_SHAPES`` and ``FLASH_BWD_SHAPES``, and the backward at
``FLASH_BWD_SHAPES``, at query position offset 0 (the serve and training
paths' calls), on seeded inputs; and the plain tile walk and plain
backward on the card the same way.

    python3 tools/flash_bits.py OLD NEW [--out build/flash_bits.json]

Each TREE is a checkout of the repository (``.`` for this one).  Every
tree runs in a process of its own with its own ``src/`` on the path and
its own ``build/`` directory, calling its own wrappers with the same
arguments (no ``pos_offset``: the older trees' calls); the shapes are
this tree's.  Prints, per shape and output, whether every tree's bytes
equal the first tree's; exits 1 if any differ.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path


def _digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def run_tree(shapes) -> dict:
    """Digests of every output at ``shapes`` with the wrappers on the
    path (one tree)."""
    import torch
    from repro_torch.kernels.flashprefill import (flash_prefill,
                                                  flash_prefill_bwd,
                                                  pick_tile)
    from repro_torch.kernels.ref import (NO_WINDOW, flash_prefill_bwd_ref,
                                         flash_prefill_walk)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for name, B, H, Hkv, Sq, Sk, D, causal, window in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(Sq * 7 + Sk + D)
        c = (20 / D ** 0.5) ** 0.5
        q, k, v, do = (torch.randn(B, h, n, D, generator=gen, device=dev)
                       for h, n in ((H, Sq), (Hkv, Sk), (Hkv, Sk), (H, Sq)))
        q, k, v, do = (t.to(torch.bfloat16) for t in
                       (4 * q - c, k + c, v / 4, do))
        kw = dict(causal=causal, window=window)
        win = NO_WINDOW if window is None else window
        o, lse = flash_prefill(q, k, v, return_lse=True, **kw)
        row = {"fwd": _digest(flash_prefill(q, k, v, **kw)),
               "fwd_lse": _digest(o) + _digest(lse)}
        walk = flash_prefill_walk(q, k, v, causal, win, Sk,
                                  *pick_tile(B, H, Hkv, Sq, D),
                                  return_lse=True)
        row["plain_fwd"] = _digest(walk[0]) + _digest(walk[1])
        if Sq == Sk or not causal:
            row["bwd"] = "".join(_digest(g) for g in flash_prefill_bwd(
                q, k, v, o, lse, do, **kw))
            row["plain_bwd"] = "".join(_digest(g) for g in
                                       flash_prefill_bwd_ref(
                                           q, k, v, o, lse, do, causal, win,
                                           Sk))
        torch.cuda.synchronize()
        out[name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default="build/flash_bits.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # worker: shapes file
    args = ap.parse_args()
    if args.one:
        shapes = json.loads(Path(args.one).read_text())
        print("DIGESTS " + json.dumps(run_tree(shapes)), flush=True)
        return 0
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as C
    shapes = [(n, B, H, Hkv, S, S, D, c, w)
              for n, B, H, Hkv, S, D, c, w in C.FLASH_SHAPES] + \
        [list(s) for s in C.FLASH_BWD_SHAPES]
    spec = Path(args.out).with_suffix(".shapes.json")
    spec.parent.mkdir(parents=True, exist_ok=True)
    spec.write_text(json.dumps(shapes))
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
        print(f"{name:32s} " + "  ".join(
            f"{k} {'same' if v else 'DIFFERENT'}" for k, v in row.items()))
    ok = all(all(r.values()) for r in same.values())
    Path(args.out).write_text(json.dumps({"trees": args.trees, "same": same,
                                          "ok": ok}, indent=1))
    print("flash_bits:", "every output the same bits" if ok else
          "outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
