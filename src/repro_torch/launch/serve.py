"""Serving driver: the continuous-batching engine with Poisson arrivals.

Port of ``repro.launch.serve``; runs on the card unless ``--device cpu``.
Reports throughput and TTFT / latency percentiles.  ``--arch`` takes the
ported architectures (the dense smollm-360m, gemma3-1b, chatglm3-6b and
mistral-large-123b, the moe llama4-scout-17b-a16e and arctic-480b, the
vlm internvl2-2b, the ssm rwkv6-7b, the hybrid recurrentgemma-2b, the
audio whisper-tiny), REDUCED unless ``--full``; the full configurations
of mistral-large-123b, llama4-scout-17b-a16e and arctic-480b do not fit
one card (the engine draws their bf16 weights before packing).  The KV store is the dense slab
unless ``--cache-kind paged`` (dense and moe families), where
``--enable-prefix-caching`` shares full prompt-prefix blocks and
``--enable-block-growth`` (with ``--reserve-headroom-blocks``) admits on
prompt blocks and preempts when the pool runs dry; ``--policy`` takes any
``WxAyKVz`` name; ``--attn-impl xla`` swaps the decode-attention kernels
for the reference's opt-out (plain fused attention over the slab or a
view gathered from the pool).  internvl2-2b prefills 256 (REDUCED: 16)
stub image rows before the prompt, so ``--max-seq`` must hold them;
rwkv6-7b prefills a prompt of n tokens as n - 1 < 64 or a multiple of 64
(its chunked form's rule), so ``--prompt-len`` 12 or 129 serve.

Usage:
    python -m repro_torch.launch.serve --arch smollm-360m --full \
        --policy w4a8kv4 --cache-kind paged --requests 16 --rate 8
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --full \
        --max-seq 512 --prompt-len 128
    python -m repro_torch.launch.serve --arch whisper-tiny --device cpu
    python -m repro_torch.launch.serve --arch gemma3-1b --full \
        --max-seq 1536 --prompt-len 1100 --prefill-chunk 128
    python -m repro_torch.launch.serve --arch chatglm3-6b --device cpu \
        --attn-impl xla --cache-kind paged
    python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \
        --device cpu --cache-kind paged --enable-prefix-caching
    python -m repro_torch.launch.serve --arch internvl2-2b --full \
        --max-seq 384 --prompt-len 64
    python -m repro_torch.launch.serve --arch rwkv6-7b --full \
        --prompt-len 129
    python -m repro_torch.launch.serve --full --cache-kind paged \
        --enable-prefix-caching --enable-block-growth --n-blocks 32
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
    if config.enable_prefix_caching or config.enable_block_growth:
        print(f"prefix-cached tokens {sum(o.cached_tokens for o in finished)}"
              f", preemptions {sum(o.num_preemptions for o in finished)}, "
              f"replay iterations "
              f"{sum(o.replay_iterations for o in finished)}, peak live "
              f"blocks {eng.allocator.peak_live} of {eng.n_blocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
