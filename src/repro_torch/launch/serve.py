"""Serving driver: the continuous-batching engine with Poisson arrivals.

Port of ``repro.launch.serve``; runs on the card unless ``--device cpu``.
Reports throughput and TTFT / latency percentiles.  ``--arch`` takes the
ported architectures (smollm-360m, recurrentgemma-2b, whisper-tiny),
REDUCED unless ``--full``.  The KV store is the dense slab unless
``--cache-kind paged`` (dense family only); ``--policy`` takes any
``WxAyKVz`` name.

Usage:
    python -m repro_torch.launch.serve --arch smollm-360m --full \
        --policy w4a8kv4 --cache-kind paged --requests 16 --rate 8
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --full \
        --max-seq 512 --prompt-len 128
    python -m repro_torch.launch.serve --arch whisper-tiny --device cpu
"""
import argparse
import sys


def main(argv=None) -> int:
    """Serve Poisson-arriving random prompts; print throughput and latency."""
    from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                     SamplingParams, percentile_stats)

    ap = argparse.ArgumentParser()
    EngineConfig.add_cli_args(ap, max_seq=128)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0, help="req/s (Poisson)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.7)
    args = ap.parse_args(argv)

    import time

    import numpy as np

    try:
        config = EngineConfig.from_cli(args)
    except EngineError as e:
        print(f"invalid engine configuration: {e}", file=sys.stderr)
        return 2
    eng = Engine(config)
    vocab = config.model.vocab
    rng = np.random.default_rng(config.seed)
    # Poisson arrival schedule (paper §5.1: workload from a Poisson process)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    finished = []
    t_start = eng.now()
    submitted = 0
    while submitted < args.requests or not eng.scheduler.idle:
        now = eng.now() - t_start
        while submitted < args.requests and arrivals[submitted] <= now:
            prompt = rng.integers(1, vocab, size=args.prompt_len).tolist()
            try:
                eng.submit(prompt, SamplingParams(
                    temperature=args.temperature, top_k=40,
                    max_new_tokens=args.max_new))
            except EngineError as e:
                print(f"rejected request: {e}", file=sys.stderr)
            submitted += 1
        if eng.scheduler.idle:
            time.sleep(0.001)
            continue
        finished.extend(o for o in eng.step() if o.finished)

    total_tokens = sum(len(o.output_token_ids) for o in finished)
    wall = eng.now() - t_start
    print(f"served {len(finished)} requests, {total_tokens} tokens "
          f"in {wall:.2f}s → {total_tokens / wall:.1f} tok/s "
          f"on {config.device}")
    print("TTFT percentiles (s):",
          {k: round(v, 4) for k, v in percentile_stats(
              [o.ttft for o in finished]).items()})
    print("latency percentiles (s):",
          {k: round(v, 4) for k, v in percentile_stats(
              [o.latency for o in finished]).items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
