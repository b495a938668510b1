"""End-to-end serving example: a small model served with continuous
batching, mixed-precision weights and KV cache, Poisson request arrivals,
and the paper's metrics (throughput / TTFT / latency percentiles), all
through the streaming serving API (EngineConfig / step() → RequestOutput /
stream()).  Port of ``examples/serve_continuous_batching.py``.

The workload is the shape prefix caching exists for: every request is a
*shared system prompt* plus a short unique user suffix.  The engine runs
the paged KV backend with ``enable_prefix_caching`` (on the card through
the paged attention kernel, ``csrc/paged_kvattn.cu``), so after the first
request publishes the system prompt's KV blocks, later requests map the
same physical blocks into their tables (``cached_tokens`` below) instead
of recomputing the prefill — identical output streams, less work.

    python -m repro_torch.examples.serve_continuous_batching
    python -m repro_torch.examples.serve_continuous_batching --device cpu
"""
import argparse

ARCH = "smollm-360m"
N_REQUESTS = 16
RATE = 4.0          # requests/s, Poisson (paper §5.1 workload model)
SYS_LEN = 24        # shared system-prompt tokens (3 full KV blocks)


def main(argv=None) -> dict:
    """Serve the Poisson workload, then stream one seeded request; print
    the reference's lines and return the finished outputs and the
    streamed tokens."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.serving import (Engine, EngineConfig, SamplingParams,
                                     percentile_stats)

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(ARCH)
    engine = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                                 max_seq=96, max_prompt=48,
                                 cache_kind="paged", block_size=8,
                                 enable_prefix_caching=True,
                                 device=args.device))
    print(f"serving {cfg.name} with policy w4a16kv8, "
          f"{engine.n_slots} continuous-batching slots, paged KV "
          f"({engine.n_blocks} blocks of {engine.block_size}) "
          f"+ prefix caching")

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, cfg.vocab, size=SYS_LEN).tolist()
    arrivals = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS))
    t0 = engine.now()
    finished, nxt = [], 0
    while nxt < N_REQUESTS or not engine.scheduler.idle:
        now = engine.now() - t0
        while nxt < N_REQUESTS and arrivals[nxt] <= now:
            suffix = rng.integers(1, cfg.vocab, size=rng.integers(2, 8))
            engine.submit(system_prompt + suffix.tolist(), SamplingParams(
                temperature=0.8, top_k=40, max_new_tokens=16))
            nxt += 1
        if not engine.scheduler.idle:
            for out in engine.step():
                if out.finished:
                    finished.append(out)
                    print(f"  req {out.rid}: prompt {out.prompt_len} toks "
                          f"({out.cached_tokens} from prefix cache) → "
                          f"{len(out.output_token_ids)} new "
                          f"({out.finish_reason.value})  "
                          f"ttft {out.ttft:.3f}s  latency {out.latency:.3f}s")

    total = sum(len(o.output_token_ids) for o in finished)
    cached = sum(o.cached_tokens for o in finished)
    demand = sum(o.prompt_len - 1 for o in finished)
    wall = engine.now() - t0
    print(f"\nserved {len(finished)} requests / {total} tokens in "
          f"{wall:.2f}s → {total / wall:.1f} tok/s")
    print(f"prefix cache: {cached}/{demand} prompt tokens served from "
          f"shared blocks ({100 * cached / demand:.0f}% of prefill skipped)")
    print("TTFT:   ", {k: f"{v:.3f}s" for k, v in
                       percentile_stats([o.ttft for o in finished]).items()})
    print("latency:", {k: f"{v:.3f}s" for k, v in percentile_stats(
        [o.latency for o in finished]).items()})

    # -- token-by-token streaming (seeded: reproducible across batch mixes)
    print("\nstreaming one seeded request token-by-token:")
    stream_params = SamplingParams(temperature=0.7, top_k=40,
                                   max_new_tokens=8, seed=1234)
    streamed = []
    for out in engine.stream(system_prompt + [7, 3, 5, 11], stream_params):
        tag = f" [{out.finish_reason.value}]" if out.finished else ""
        print(f"  t={len(out.output_token_ids):2d}  "
              f"+{out.new_token_ids}{tag}")
        streamed += out.new_token_ids
    return {"finished": finished, "streamed": streamed,
            "cached_tokens": cached, "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
