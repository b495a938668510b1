"""Holistic mixed-precision support (the paper's Pillar 2): one model,
many WxAyKVz formats — including QServe's hard-wired W4A8KV4, which takes
the s8×s8 GEMM — decoded through the same model, with per-format latency
and logit agreement.  Port of ``examples/mixed_precision_formats.py``.

    python -m repro_torch.examples.mixed_precision_formats
    python -m repro_torch.examples.mixed_precision_formats --device cpu

Times are the second of two calls (the first builds the kernels and warms
the allocator); on the card each ends in a synchronize.
"""
import argparse
import time

FORMATS = ["w16a16kv16", "w8a16kv8", "w4a16kv8", "w4a16kv4", "w4a8kv4",
           "wfp8a16kvfp8"]


def main(argv=None) -> dict:
    """Prefill and decode one REDUCED smollm-360m under every format; print
    the reference's table and return its rows by format."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    def timed(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    cfg = get_reduced("smollm-360m")
    model = build(cfg)
    raw_params = model.init_params(0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    toks = torch.randint(1, cfg.vocab, (2, 12), generator=gen, device=dev)

    ref_logits, rows = None, {}
    print(f"{'format':14s} {'prefill_ms':>10s} {'decode_ms':>10s} "
          f"{'w_bytes/val':>11s} {'top1==kv16':>10s}")
    with torch.no_grad():
        for fmt in FORMATS:
            policy = get_policy(fmt)
            params = quantize_params(raw_params, policy)
            (_, cache), t_prefill = timed(lambda: model.prefill(
                params, policy, toks, model.init_cache(policy, 2, 32, dev)))
            (lg, _), t_decode = timed(lambda: model.decode_step(
                params, policy, toks[:, :1], cache, 12))
            lg = lg.float().cpu().numpy()
            if ref_logits is None:
                ref_logits = lg
            agree = float((np.argmax(lg, -1) ==
                           np.argmax(ref_logits, -1)).mean())
            rows[fmt] = dict(prefill_ms=t_prefill * 1e3,
                             decode_ms=t_decode * 1e3,
                             w_bytes_per_val=policy.weights.bytes_per_value,
                             top1_agree=agree,
                             finite=bool(np.isfinite(lg).all()))
            print(f"{fmt:14s} {t_prefill * 1e3:10.2f} {t_decode * 1e3:10.2f} "
                  f"{policy.weights.bytes_per_value:11.1f} {agree:10.2f}")
    return rows


if __name__ == "__main__":
    main()
