"""The knee of an open-loop cell: the highest arrival rate the system
sustains without a growing backlog, by a sweep on the card:

    python3 bench/sweep.py --workload <cell> --rates 2,3,4 --seconds 40

For each rate, one fresh engine serves the cell's mix at that rate (set-up
and warm-up as a run's).  One JSON line per rate: requests due and
finished in the window, those still without a first token at its end,
TTFT p50 / p95 and its mean over the window's first and last thirds (a
growing backlog shows as a rising TTFT), inter-token p95 and output
tokens a second.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv):
    from bench import harness, tails
    ap = argparse.ArgumentParser(prog="bench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve this many layers instead of the file's")
    args = ap.parse_args(argv)
    for rate in (float(r) for r in args.rates.split(",")):
        c = harness.load_cell(args.workload)
        c["traffic"]["rate_per_s"] = rate
        if args.layers:
            c["config"]["model"]["n_layers"] = args.layers
        w, out, _ = harness.serve(c, args.seed, args.seconds, False,
                                     "cuda", time.perf_counter())
        t = w.seconds
        due = sorted((d, r) for r, d in w.due.items() if 0 <= d < t)
        ttft = tails.ttfts(w.due, w.first, 0.0, t)
        third = lambda a, b: [min(w.first.get(r, t), t) - d  # noqa: E731
                              for d, r in due if a * t / 3 <= d < b * t / 3]
        mean = lambda v: sum(v) / len(v) if v else None  # noqa: E731
        print(json.dumps({
            "layers": c["config"]["model"]["n_layers"], "rate": rate,
            "due": len(due), "finished": len(out.finished),
            "no_first_token": sum(r not in w.first or w.first[r] > t
                                  for _, r in due),
            "ttft_p50_ms": tails.quantile(ttft, 0.5) * 1e3,
            "ttft_p95_ms": tails.quantile(ttft, 0.95) * 1e3,
            "ttft_first_third_ms": mean(third(0, 1)) * 1e3,
            "ttft_last_third_ms": mean(third(2, 3)) * 1e3,
            "itl_p95_ms": tails.quantile(tails.gaps(w.returns, 0.0, t),
                                         0.95) * 1e3,
            "output_tok_s": w.emitted / t,
            "fed_per_step": w.fed_tokens / max(w.model_steps, 1),
            "steps": w.model_steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
