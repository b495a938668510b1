#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits nonzero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one compiler per source, in parallel).
3. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the main path's full-width shapes (smollm-360m), and time
   kernel, plain version and a library yardstick with CUDA events, L2
   flushed before every launch.
4. Reference phase: smollm-360m REDUCED, teacher-forced through
   ``decode_step`` on the card (kernels) and on the CPU (plain versions);
   logits must agree.
5. Serve phase: the full-width smollm-360m (32 layers, d_model 960,
   seeded random weights), ``w4a16kv8``, paged, 4 slots, max_seq 256,
   block_size 16, prefill_chunk 32, serving 8 greedy requests of 64-token
   prompts and 32 new tokens through ``Engine.generate``.  The launch
   counters are zeroed just before and read just after: every GEMM and
   every attention call must have gone through the two kernels.  One
   request's stream is then replayed teacher-forced through
   ``decode_step`` and must follow its argmax.
6. One JSON line describing each kernel, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits nonzero with no result when there is no CUDA device or when the
port's sources are not beside this script.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 8, 64, 32
GEMM_SHAPES = [  # weights, K, N, bk, bn of smollm-360m's packed GEMMs
    ("wq/wo", 960, 960, 64, 96), ("wk/wv", 960, 320, 64, 64),
    ("w1/w3", 960, 2560, 64, 128), ("w2", 2560, 960, 32, 96)]
GEMM_MS = (4, 128)           # n_slots x t_step at decode and at prefill


def check(cond, msg):
    """Raise unless ``cond`` holds (survives ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, flush, iters=20):
    """Median device time of ``fn`` over ``iters`` launches, each after a
    256 MiB write that evicts the 50 MB L2 (the main path streams each
    layer's weights and KV once per step, so it finds them cold).  The
    write also keeps the card busy for ~0.1 ms, longer than the host takes
    to record the start event and enqueue ``fn``, so the events time the
    device work and not the wrapper's host latency."""
    import torch
    fn()
    ev = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes, ops):
    """Least time for the work on an H100, and what sets it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def gemm_phase(dev, flush):
    """mpgemm_w4a16 against its plain version at smollm-360m's shapes."""
    import torch
    from repro_torch.core.packing import dequantize_packed, pack_weight
    from repro_torch.kernels.mpgemm import mpgemm_w4a16
    from repro_torch.kernels.ref import mpgemm_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for name, K, N, bk, bn in GEMM_SHAPES:
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        pw = pack_weight(w, bits=4, group=bk, block_k=bk, block_n=bn)
        wd = dequantize_packed(pw, torch.bfloat16)      # yardstick operand
        for M in GEMM_MS:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            y, plain = mpgemm_w4a16(x, pw), mpgemm_ref(x, pw)
            torch.cuda.synchronize()
            err = (y.float() - plain.float()).abs().max().item()
            tol = 2 ** -7 * plain.float().abs().max().item()
            check(err <= tol, f"mpgemm {name} M={M}: |Δ|={err} > {tol}")
            nbytes = M * K * 2 + K * N // 2 + (K // bk) * N * 4 + M * N * 2
            b, by = bound_ms(nbytes, 2 * M * N * K)
            rows.append(dict(
                shape=f"{name} M={M} K={K} N={N} bk={bk} bn={bn}",
                max_abs_err=err, tol=tol,
                ms=time_ms(lambda: mpgemm_w4a16(x, pw), flush),
                plain_ms=time_ms(lambda: mpgemm_ref(x, pw), flush),
                library_ms=time_ms(lambda: torch.matmul(x, wd), flush),
                bound_ms=b, bound_by=by, bytes=nbytes, ops=2 * M * N * K))
    return rows


def attn_phase(dev, flush):
    """paged_kvattn_kv8 against its plain version at the serve shapes."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels.paged_kvattn import paged_kvattn_kv8
    from repro_torch.kernels.ref import NO_WINDOW, paged_kvattn_ref
    kv8 = get_policy("w4a16kv8").kv
    B, Hkv, rep, D, bs, bps = 4, 5, 3, 64, 16, 16
    nb = B * bps
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []
    for T, pos in ((1, [95, 36, 70, 0]), (32, [32, 0, 64, 96])):
        ctx = [p + T for p in pos]
        cache = PKV.init_paged(B, nb, bs, Hkv, D, kv8, bps, device=dev)
        lay = cache.layer(0)
        lay.k.copy_(torch.randint(-127, 128, lay.k.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        lay.v.copy_(torch.randint(-127, 128, lay.v.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
        nxt = 0
        for b, n in enumerate(ctx):           # shuffled table, sentinel tail
            need = PKV.blocks_needed(n, bs)
            lay.block_table[b, :need] = perm[nxt:nxt + need]
            nxt += need
            k = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
            v = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
            row = dataclasses.replace(lay, block_table=lay.block_table[b:b + 1])
            PKV.append_paged(row, k.to(torch.bfloat16), v.to(torch.bfloat16),
                             torch.zeros(1, dtype=torch.int32, device=dev), kv8)
        R = T * rep
        q = torch.randn(B, Hkv, R, D, generator=gen, device=dev).to(
            torch.bfloat16)
        posd = torch.tensor(pos, dtype=torch.int32, device=dev)
        n_live = PKV.blocks_needed(max(ctx), bs)
        args = (q, lay.k, lay.k_scale, lay.v, lay.v_scale, lay.block_table,
                posd, NO_WINDOW, rep, n_live)
        out, plain = paged_kvattn_kv8(*args), paged_kvattn_ref(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(), "attention not finite")
        err = (out.float() - plain.float()).abs().max().item()
        check(err <= 3e-2, f"paged_kvattn T={T}: |Δ|={err} > 3e-2")
        # yardstick: SDPA over a gathered, dequantized bf16 view
        S = n_live * bs
        tbl = lay.block_table[:, :n_live].long().clamp(max=nb - 1)

        def view(pool, sc):
            t = pool[tbl].reshape(B, S, Hkv, D).permute(0, 2, 1, 3)
            s = sc[tbl].reshape(B, S, Hkv).permute(0, 2, 1)
            return (t.float() * s[..., None]).to(torch.bfloat16).contiguous()

        kd, vd = view(lay.k, lay.k_scale), view(lay.v, lay.v_scale)
        qh = q.reshape(B, Hkv, T, rep, D).permute(0, 1, 3, 2, 4) \
            .reshape(B, Hkv * rep, T, D).contiguous()
        qpos = posd.long()[:, None] + torch.arange(T, device=dev)
        mask = (torch.arange(S, device=dev)[None, None] <=
                qpos[:, :, None])[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qh, kd, vd, attn_mask=mask, enable_gqa=True)
        check(torch.isfinite(sdpa().float()).all().item(), "SDPA not finite")
        # bytes the data needs: each slot's live keys (int8 K and V + two
        # f32 scales), q and out, the table rows walked, positions
        keys = sum(ctx)
        nbytes = keys * Hkv * (2 * D + 8) + 2 * B * Hkv * R * D * 2 + \
            B * n_live * 4 + B * 4
        ops = sum(4 * D * Hkv * (p + r // rep + 1) for p in pos
                  for r in range(R))
        b, by = bound_ms(nbytes, ops)
        rows.append(dict(
            shape=f"B={B} Hkv={Hkv} rep={rep} D={D} T={T} R={R} bs={bs} "
                  f"n_live={n_live}",
            max_abs_err=err, tol=3e-2,
            ms=time_ms(lambda: paged_kvattn_kv8(*args), flush),
            plain_ms=time_ms(lambda: paged_kvattn_ref(*args), flush),
            library_ms=time_ms(sdpa, flush),
            bound_ms=b, bound_by=by, bytes=nbytes, ops=ops))
    return rows


def to_device(params, dev):
    """Parameter dict/list of tensors and PackedWeights → ``dev``."""
    if isinstance(params, dict):
        return {k: to_device(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, dev) for v in params]
    return params.to(dev)


def teacher_forced(model, params, policy, cache, stream, chunks, max_live):
    """Feed ``stream`` (1-D list) through decode_step in ``chunks`` (lists
    of token counts); returns the float logits of every step's last row."""
    import torch
    dev = cache.k.device
    out, p = [], 0
    for n in chunks:
        toks = torch.tensor([stream[p:p + n]], dtype=torch.int64, device=dev)
        logits, _ = model.decode_step(
            params, policy, toks, cache,
            torch.tensor([p], dtype=torch.int32, device=dev),
            max_live=max_live(p))
        out.append(logits[0].float().cpu())
        p += n
    return out


def reference_phase(dev):
    """REDUCED smollm: the kernels on the card against the plain versions
    on the CPU, teacher-forced, same packed weights."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    cfg, pol = get_reduced("smollm-360m"), get_policy("w4a16kv8")
    model = build(cfg)
    params = quantize_params(model.init_params(0, "cpu"), pol)
    stream = torch.randint(1, cfg.vocab, (12,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    chunks = [4, 4] + [1] * 4
    logits = {}
    for d in ("cpu", dev):
        cache = model.init_paged_cache(pol, 1, 4, 8, 4, d)
        cache.block_table.copy_(torch.tensor([[2, 0, 3, 1]]))
        logits[str(d)] = teacher_forced(model, to_device(params, d), pol,
                                        cache, stream, chunks,
                                        lambda p: 32)
    worst = 0.0
    for lc, lg in zip(logits["cpu"], logits[str(dev)]):
        check(torch.isfinite(lg).all().item(), "reference logits not finite")
        scale = lc.abs().max().item()
        rel = (lg - lc).abs().max().item() / scale
        worst = max(worst, rel)
        check(rel <= 2e-2, f"REDUCED logits: card vs CPU rel err {rel}")
        top2 = lc.topk(2).values
        if (top2[0] - top2[1]).item() > 2e-2 * scale:
            check(lg.argmax().item() == lc.argmax().item(), "top-1 differs")
    return worst


def profile_window(eng, prompts, sp):
    """Where a short serving window's time goes: ``torch.profiler``'s
    device events (kernels and copies) summed against the host wall clock
    of the same window.  Runs after the counted window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps0 = eng.model_steps
        eng.generate(prompts, sp)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        steps = eng.model_steps - steps0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(steps=steps, wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / wall_us,
                top_device=[dict(name=k[:60], ms=t / 1e3, count=n)
                            for k, (t, n) in top])


def serve_phase(dev):
    """Serve full-width smollm-360m and check the kernels carried it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.kernels.mpgemm import mpgemm_w4a16
    from repro_torch.kernels.paged_kvattn import paged_kvattn_kv8
    from repro_torch.serving import (Engine, EngineConfig, SamplingParams,
                                     percentile_stats)
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                              max_seq=256, block_size=16, prefill_chunk=32,
                              seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (N_REQUESTS, PROMPT_LEN)).tolist()
    sp = SamplingParams(max_new_tokens=NEW_TOKENS)
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))   # warm-up

    mpgemm_w4a16.launches = paged_kvattn_kv8.launches = 0
    steps0 = eng.model_steps
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mpgemm_w4a16": mpgemm_w4a16.launches,
                "paged_kvattn_kv8": paged_kvattn_kv8.launches}
    steps = eng.model_steps - steps0
    L = cfg.n_layers
    check(len(outs) == N_REQUESTS and all(
        len(o.output_token_ids) == NEW_TOKENS for o in outs),
        "not every request produced its tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.output_token_ids),
          "token outside the vocabulary")
    check(launches["mpgemm_w4a16"] == 7 * L * steps,
          f"GEMM launches {launches['mpgemm_w4a16']} != 7*{L}*{steps}")
    check(launches["paged_kvattn_kv8"] == L * steps,
          f"attention launches {launches['paged_kvattn_kv8']} != {L}*{steps}")
    check(eng.allocator.live_count == 0, "KV blocks leaked")

    # request 0, teacher-forced on the card: each emitted token must be
    # the argmax of decode_step's logits up to a near-tie
    stream = prompts[0] + outs[0].output_token_ids
    cache = eng.model.init_paged_cache(eng.policy, 1, 16, 16, 16, dev)
    cache.block_table.copy_(torch.arange(16, dtype=torch.int32)[None])
    chunks = [32, 32] + [1] * (NEW_TOKENS - 1)
    tf = teacher_forced(
        eng.model, eng.params, eng.policy, cache, stream, chunks,
        lambda p: min(1 << (PKV.blocks_needed(p + 1, 16) - 1).bit_length(),
                      16) * 16)
    for lg, tok in zip(tf[1:], outs[0].output_token_ids):
        check(lg[tok].item() >= lg.max().item() - 2e-2 * lg.abs().max().item(),
              "served token is not the teacher-forced argmax")

    toks = sum(len(o.output_token_ids) for o in outs)
    return dict(
        profile=profile_window(eng, prompts[:4], SamplingParams(
            max_new_tokens=8)),
        requests=N_REQUESTS, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
        model_steps=steps, wall_s=wall, tokens_per_s=toks / wall,
        ms_per_step=wall / steps * 1e3,
        ttft_p50_s=percentile_stats([o.ttft for o in outs])["p50"],
        latency_p50_s=percentile_stats([o.latency for o in outs])["p50"],
        setup_s=setup_s, launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def summarize(rows, launches, **meta):
    """One kernel's line: sums over its main-path shapes."""
    return dict(meta, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=("bytes" if sum(r["bytes"] for r in rows)
                          / HBM_BYTES_PER_S >= sum(r["ops"] for r in rows)
                          / BF16_OPS_PER_S else "operations"),
                library_ms=sum(r["library_ms"] for r in rows),
                shapes=rows)


def main() -> int:
    """Run every phase; return the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[p.name for p in libs]} in {time.perf_counter() - t0:.1f} s")
    for p in libs:
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {p.stem.split('-')[0]}: {line.strip()}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gemm_rows = gemm_phase(dev, flush)
    attn_rows = attn_phase(dev, flush)
    for r in gemm_rows + attn_rows:
        print(f"  {r['shape']:44s} err {r['max_abs_err']:.3g} "
              f"kernel {r['ms'] * 1e3:8.1f} us  plain {r['plain_ms'] * 1e3:8.1f}"
              f" us  library {r['library_ms'] * 1e3:7.1f} us  bound "
              f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']})")
    del flush
    rel = reference_phase(dev)
    print(f"reference: REDUCED logits, card vs CPU, max rel err {rel:.3g}")
    serve = serve_phase(dev)
    print("serve:", json.dumps(serve))

    kernels = [
        summarize(gemm_rows, serve["launches"]["mpgemm_w4a16"],
                  name="mpgemm_w4a16", route="cuda",
                  source="src/repro_torch/csrc/mpgemm.cu",
                  replaces="src/repro/kernels/mpgemm.py:137"),
        summarize(attn_rows, serve["launches"]["paged_kvattn_kv8"],
                  name="paged_kvattn_kv8", route="cuda",
                  source="src/repro_torch/csrc/paged_kvattn.cu",
                  replaces="src/repro/kernels/paged_kvattn.py:85"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
