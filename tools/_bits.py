"""The driver that ``tools/flash_bits.py``, ``kvattn_bits.py`` and
``gemm_bits.py`` share: it runs one tool's cases in every tree given and
says, per case and output, whether every tree's bytes equal the first
tree's.

Each TREE is a checkout of the repository (``.`` for this one) and runs in
a process of its own (the tool again, with a hidden ``--one`` argument)
with its own ``src/`` on the path and its own ``build/`` directory; the
cases are this tree's.  A worker's ``run_tree`` maps each case to a dict
of digests, or to ``None`` where that tree refuses the case (an older
tree); a case is compared among the trees that ran it.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def chip_smoke():
    """This tree's ``chip_smoke`` module, whose tables hold the cases."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    return C


def main(tool: str, shapes, run_tree, width: int = 52) -> int:
    """The command line of ``tools/<tool>_bits.py``: ``shapes()`` gives the
    cases (JSON-able), ``run_tree(cases)`` their digests in one tree.
    Writes ``--out`` and exits 1 if any output differs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default=f"build/{tool}_bits.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # worker: cases file
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
        r = subprocess.run([sys.executable, sys.argv[0], "--one", str(spec)],
                           env=dict(os.environ, PYTHONPATH=src),
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:])
            return 1
        line = [x for x in r.stdout.splitlines()
                if x.startswith("DIGESTS ")][-1]
        runs.append(json.loads(line[len("DIGESTS "):]))
    rows, ok = {}, True
    for name in runs[0]:
        ran = [run[name] for run in runs if run[name] is not None]
        refused = [t for t, run in zip(args.trees, runs) if run[name] is None]
        row = {k: all(d[k] == ran[0][k] for d in ran)
               for k in ran[0]} if ran else {}
        ok &= all(row.values())
        rows[name] = dict(row, refused_by=refused)
        print(f"{name:{width}s} " + "  ".join(
            f"{k} {'same' if v else 'DIFFERENT'}" for k, v in row.items()) +
            (f"  refused by {refused}" if refused else ""))
    Path(args.out).write_text(json.dumps({"trees": args.trees, "rows": rows,
                                          "ok": ok}, indent=1))
    n = sum(1 for r in rows.values() if not r["refused_by"])
    print(f"{tool}_bits: {n} of {len(rows)} cases run by every tree;",
          "every output the same bits" if ok else "outputs differ")
    return 0 if ok else 1
