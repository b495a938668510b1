"""The readings the limits of ``correct`` are set from, on the card:

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 25

For each seed, one process serves the cell's traffic at its own load for
``--seconds`` (set-up and warm-up as a run's), then judges over the same
sample of finished requests as a run: the program's served tokens (the
sound reading) and, in the program's place, the control's first choices:
the reference computed with its KV cache at 4 bits (``kv4``) and with its
GEMM inputs at 8 bits (``a8``).  Each is judged as a run judges the
program (``bench.check``): its numbers beside their limits and whether
they come out correct.  One JSON line per seed.
"""
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv):
    import torch
    from bench import check, harness
    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args(argv)
    c = harness.load_cell(args.workload)
    cfg = c["config"]
    lower = {"kv4": dict(kv_bits=4), "a8": dict(act_bits=8)}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, out, _ = harness.serve(c, seed, args.seconds, False, "cuda", t0)
        params = c["arch"].draw(harness.shapes(cfg), seed, "cuda")
        served = out.finished
        rids = check.sample(served, seed, cfg["check"]["served_tokens"])
        judge = check.Judge(c, params, served, rids)
        program, info = judge.numbers([served[r].tokens for r in rids])
        row = {"seed": seed, "requests": len(rids),
               "served_tokens": sum(len(served[r].tokens) for r in rids),
               "program": {k: v for k, (v, _) in program.items()},
               "program_correct": check.judged(program), **info}
        for name, prec in lower.items():
            nums, inf = check.control(c, params, served, seed, judge,
                                      **prec)
            row[name] = {k: v for k, (v, _) in nums.items()}
            row[name]["mean_logit_gap"] = inf["mean_logit_gap"]
            if "max_gap_by_tie" in inf:
                row[name]["max_gap_by_tie"] = inf["max_gap_by_tie"]
            row[name + "_correct"] = check.judged(nums)
        row["limits"] = {k: lim for k, (_, lim) in program.items()}
        row["seconds"] = time.perf_counter() - t0
        del params, judge
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
