#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits nonzero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one compiler per source, in parallel).
3. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the main paths' full-width shapes — both GEMMs at bits 4 and 8
   at smollm-360m's and recurrentgemma-2b's packed shapes, the weights in
   the kernels' fragment order, paged and dense-slab attention in every KV
   format (smollm-360m), flash prefill at recurrentgemma-2b's local
   attention (S 127 and 4096, window 2048, D 256, 10 query heads on one
   KV head), whisper-tiny's encoder (S 1500, non-causal, D 64) and its
   decoder prompt (S 15, causal, D 64), at the tile its wrapper picks —
   on peaked inputs (a few keys carry each row), and time kernel, plain
   version and a library yardstick with CUDA events, L2 flushed before
   every launch; flash prefill is timed at every tile its wrapper can
   pick.  The dense and paged attention kernels must agree bit for bit,
   and a 32-token chunk's rows must be the bits of the same tokens fed
   one at a time and of each slot served alone.
4. Reference phase: smollm-360m REDUCED, teacher-forced through
   ``decode_step`` on the card (kernels) and on the CPU (plain versions),
   on both KV backends under w4a16kv8, w4a8kv4, w8a8kvfp8 and w8a16kv16;
   recurrentgemma-2b and whisper-tiny REDUCED, one-shot ``prefill`` then
   teacher-forced ``decode_step``, under w4a16kv8 and w16a16kv16; logits
   must agree.
5. Serve phase: the full-width smollm-360m (32 layers, d_model 960,
   seeded random weights), 4 slots, max_seq 256, block_size 16,
   prefill_chunk 32, greedy, through ``Engine.generate`` on the dense slab
   and on the paged pool: ``w4a16kv8`` serving 8 requests of 64-token
   prompts and 32 new tokens, then w4a8kv4, w8a8kvfp8 and w8a16kv16
   serving 4 requests of 32-token prompts and 16 new tokens.  Then the
   one-shot-prefill families on the dense slab under w4a16kv8: full-width
   recurrentgemma-2b (26 layers, d_model 2560, vocab 256000), max_seq 512,
   4 requests of 128-token prompts, and full-width whisper-tiny (4 + 4
   layers, 1500 frames), max_seq 256, 4 requests of 16-token prompts, 16
   new tokens each.  Around each serve the launch counters are zeroed just
   before and read just after: every GEMM must have gone through the
   kernel its policy routes to and every attention call through its
   kernel (smollm: 7 GEMMs and 1 attention call per layer and step; the
   one-shot families: 8 flash-prefill launches per request, and their
   packed GEMMs per prefill and per step on the A16 kernel).  For each
   smollm policy the dense and paged token streams must be identical.
   One request per w4a16kv8 serve is replayed teacher-forced and must
   follow its argmax.
6. One JSON line describing each kernel, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits nonzero with no result when there is no CUDA device or when the
port's sources are not beside this script.
"""
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak
GEMM_SHAPES = [  # weights, K, N, bk, bn of smollm-360m's packed GEMMs
    ("wq/wo", 960, 960, 64, 96), ("wk/wv", 960, 320, 64, 64),
    ("w1/w3", 960, 2560, 64, 128), ("w2", 2560, 960, 32, 96)]
#: recurrentgemma-2b's packed GEMMs
RG_GEMM_SHAPES = [
    ("wq/wo/wx/wy/wa/wi", 2560, 2560, 32, 128), ("wk/wv", 2560, 256, 32, 128),
    ("w1/w3", 2560, 7680, 32, 96), ("w2", 7680, 2560, 32, 128)]
#: whisper-tiny's packed GEMMs (encoder, decoder and cross attention)
WH_GEMM_SHAPES = [
    ("wq/wk/wv/wo", 384, 384, 128, 128), ("w1", 384, 1536, 128, 96),
    ("w2", 1536, 384, 32, 128)]
GEMM_MS = (4, 128)           # n_slots x t_step at decode and at prefill
#: flash prefill at the one-shot serves' shapes: (name, B, H, Hkv, S, D,
#: causal, window) — recurrentgemma's local attention at the serve prompt
#: and where the window binds, whisper-tiny's encoder (not a tile multiple)
#: and its decoder prompt (the serve's 16-token prompt less its last token)
FLASH_SHAPES = [
    ("recurrentgemma S127", 1, 10, 1, 127, 256, True, 2048),
    ("recurrentgemma S4096", 1, 10, 1, 4096, 256, True, 2048),
    ("whisper encoder S1500", 1, 6, 6, 1500, 64, False, None),
    ("whisper decoder S15", 1, 6, 6, 15, 64, True, None)]
#: flash prefill's bar against its plain version: two bf16 ulps of the
#: largest output (both round p and the output to bf16 at the same points;
#: f32 sum order flips a rounding now and then)
FLASH_REL_TOL = 2 ** -6
#: decode attention's bar against its plain version, on peaked inputs: two
#: bf16 ulps of the largest output (the kernel's eight splits round p
#: against other running maxima than the plain walk's single order)
ATTN_REL_TOL = 2 ** -6
KV_FORMATS = ("kv8", "kv4", "kvfp8", "kv16")
#: (policy, requests, prompt length, new tokens) of the serve phase
SERVES = [("w4a16kv8", 8, 64, 32), ("w4a8kv4", 4, 32, 16),
          ("w8a8kvfp8", 4, 32, 16), ("w8a16kv16", 4, 32, 16)]
#: the one-shot-prefill serves: (arch, max_seq, requests, prompt length,
#: new tokens, packed GEMMs per prefill call, per decode step), w4a16kv8 on
#: the dense slab.  recurrentgemma: 18 recurrent blocks x 8 GEMMs (wy, wx,
#: wa, wi, wo, w1, w3, w2) + 8 attention blocks x 7; whisper: prefill 4
#: encoder layers x 6 + 4 cross K/V pairs + 4 decoder layers x 8 (wq, wk,
#: wv, wo, xwq, xwo, w1, w2), a step the decoder's 32.  Every prefill runs
#: 8 flash-prefill launches (8 attention blocks; 4 encoder + 4 decoder).
ONE_SHOT_SERVES = [("recurrentgemma-2b", 512, 4, 128, 16, 200, 200),
                   ("whisper-tiny", 256, 4, 16, 16, 64, 32)]
FLASH_PER_PREFILL = 8
#: logits tolerance, relative to max |logit|: A8 policies re-quantize
#: every GEMM input per token, which turns one-ulp differences of sum
#: order into int8 rounding flips (tests/test_torch_model.py)
TOL, TOL_A8 = 2e-2, 1e-1


def check(cond, msg):
    """Raise unless ``cond`` holds (survives ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, flush, iters=20):
    """Median device time of ``fn`` over ``iters`` launches, each after a
    1 GiB write that evicts the 50 MB L2 (the main path streams each
    layer's weights and KV once per step, so it finds them cold).  The
    write also keeps the card busy for ~0.4 ms, longer than the host takes
    to record the start event and enqueue ``fn`` (a library call with
    several launches included), so the events time the device work and
    not the host's latency."""
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


def bound_ms(nbytes, ops, ops_per_s=BF16_OPS_PER_S):
    """Least time for the work on an H100, and what sets it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def gemm_phase(dev, flush):
    """Both GEMM kernels against their plain versions at smollm-360m's,
    recurrentgemma-2b's and whisper-tiny's packed shapes, bits 4 and 8,
    the weights in the kernels' fragment order."""
    import torch
    from repro_torch.core.packing import (dequantize_packed, pack_weight,
                                          to_kernel_layout)
    from repro_torch.core.quantize import quantize_act_per_token
    from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
    from repro_torch.kernels.ref import mpgemm_int8_ref, mpgemm_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = {"mpgemm_a16": [], "mpgemm_int8": []}
    shapes = [(f"smollm {n}", *shape) for n, *shape in GEMM_SHAPES] + \
        [(f"recurrentgemma {n}", *shape) for n, *shape in RG_GEMM_SHAPES] + \
        [(f"whisper {n}", *shape) for n, *shape in WH_GEMM_SHAPES]
    for name, K, N, bk, bn in shapes:
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        for bits in (4, 8):
            # the kernels take their fragment orders; the plain versions
            # read the JAX package's tile-major bytes
            pw = pack_weight(w, bits=bits, group=bk, block_k=bk, block_n=bn)
            frag = {k: to_kernel_layout(pw, k) for k in ("a16", "a8")}
            wd = dequantize_packed(pw, torch.bfloat16)   # yardstick operand
            wbytes = K * N * bits // 8 + (K // bk) * N * 4
            for M in GEMM_MS:
                x = torch.randn(M, K, generator=gen, device=dev).to(
                    torch.bfloat16)
                xq, xs = quantize_act_per_token(x.float(), bits=8)
                for kern, fn, args, plain, pargs, xbytes, peak, lib in (
                        ("mpgemm_a16", mpgemm_a16, (x, frag["a16"]),
                         mpgemm_ref, (x, pw), M * K * 2, BF16_OPS_PER_S,
                         lambda: torch.matmul(x, wd)),
                        ("mpgemm_int8", mpgemm_int8, (xq, xs, frag["a8"]),
                         mpgemm_int8_ref, (xq, xs, pw), M * K + M * 4,
                         INT8_OPS_PER_S, None)):
                    y, ref = fn(*args), plain(*pargs)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    tol = 2 ** -7 * ref.float().abs().max().item()
                    check(err <= tol, f"{kern} {name} bits={bits} M={M}: "
                                      f"|Δ|={err} > {tol}")
                    nbytes = xbytes + wbytes + M * N * 2
                    ops = 2 * M * N * K
                    b, by = bound_ms(nbytes, ops, peak)
                    rows[kern].append(dict(
                        shape=f"{name} bits={bits} M={M} K={K} N={N} "
                              f"bk={bk} bn={bn}",
                        max_abs_err=err, tol=tol,
                        ms=time_ms(lambda: fn(*args), flush),
                        plain_ms=time_ms(lambda: plain(*pargs), flush),
                        library_ms=None if lib is None
                        else time_ms(lib, flush),
                        bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
                        ops_per_s=peak))
    return rows


def kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx):
    """A paged pool holding ``ctx[b]`` random tokens for slot b through a
    shuffled block table (sentinel tail) and a dense slab of ``bps * bs``
    tokens per slot holding the same tokens; every other cell of both
    holds finite garbage stored in ``spec``."""
    import dataclasses

    import torch
    from repro_torch.core import kvcache as KV
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.core.quantize import quantize_kv
    nb = B * bps
    pool = PKV.init_paged(B, nb, bs, Hkv, D, spec, bps, device=dev).layer(0)
    slab = KV.init_cache(B, bps * bs, Hkv, D, spec, device=dev).layer(0)
    for store in (pool, slab):
        for buf, sc in ((store.k, store.k_scale), (store.v, store.v_scale)):
            g = torch.randn(tuple(sc.shape) + (D,), generator=gen, device=dev)
            q, s = quantize_kv(g.to(torch.bfloat16), spec)
            buf.copy_(q)
            sc.copy_(s[..., 0])
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    nxt = 0
    for b, n in enumerate(ctx):
        need = PKV.blocks_needed(n, bs)
        pool.block_table[b, :need] = perm[nxt:nxt + need]
        nxt += need
        k = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
        v = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        row = dataclasses.replace(pool, block_table=pool.block_table[b:b + 1])
        PKV.append_paged(row, k, v, zero, spec)
        KV.append_per_slot(KV.KVCache(slab.k[b:b + 1], slab.v[b:b + 1],
                                      slab.k_scale[b:b + 1],
                                      slab.v_scale[b:b + 1]),
                           k, v, zero, spec)
    return pool, slab


def attn_phase(dev, flush):
    """Paged and dense-slab attention against their plain versions in
    every KV format, at the serve shapes (S 256, block 16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.core.kvcache import store_dim
    from repro_torch.core.precision import get_policy
    from repro_torch.core.quantize import dequantize_kv
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    from repro_torch.kernels.ref import (NO_WINDOW, kvattn_ref,
                                         paged_kvattn_ref)
    B, Hkv, rep, D, bs, bps = 4, 5, 3, 64, 16, 16
    S = bps * bs
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = {"paged_kvattn": [], "kvattn": []}
    for fmt in KV_FORMATS:
        spec = get_policy(f"w4a16{fmt}").kv
        for T, pos in ((1, [95, 36, 70, 0]), (32, [32, 0, 64, 96])):
            ctx = [p + T for p in pos]
            pool, slab = kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx)
            R = T * rep
            # peaked: scores of std 4, so a few keys carry each row and a
            # dropped tile or split moves the output by O(1)
            q = (4 * torch.randn(B, Hkv, R, D, generator=gen, device=dev)).to(
                torch.bfloat16)
            posd = torch.tensor(pos, dtype=torch.int32, device=dev)
            n_live = PKV.blocks_needed(max(ctx), bs)
            pargs = (q, pool.k, pool.k_scale, pool.v, pool.v_scale,
                     pool.block_table, posd, NO_WINDOW, rep, n_live)
            dargs = (q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd,
                     NO_WINDOW, rep)
            # yardstick: SDPA over the slab's live prefix, dequantized bf16
            Sl = n_live * bs
            kd, vd = (dequantize_kv(t[:, :Sl], sc[:, :Sl, :, None], spec)
                      .permute(0, 2, 1, 3).contiguous()
                      for t, sc in ((slab.k, slab.k_scale),
                                    (slab.v, slab.v_scale)))
            qh = q.reshape(B, Hkv, T, rep, D).permute(0, 1, 3, 2, 4) \
                .reshape(B, Hkv * rep, T, D).contiguous()
            qpos = posd.long()[:, None] + torch.arange(T, device=dev)
            mask = (torch.arange(Sl, device=dev)[None, None] <=
                    qpos[:, :, None])[:, None]
            sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qh, kd, vd, attn_mask=mask, enable_gqa=True)
            check(torch.isfinite(sdpa().float()).all().item(),
                  "SDPA not finite")
            # bytes the data needs: each slot's live keys (stored K and V
            # + two f32 scales), q and out, positions (+ the table rows)
            rb = store_dim(D, spec) * spec.dtype.itemsize
            keys = sum(ctx)
            ops = sum(4 * D * Hkv * (p + r // rep + 1) for p in pos
                      for r in range(R))
            outs = {}
            for kern, fn, args, plain, extra in (
                    ("paged_kvattn", paged_kvattn, pargs + (spec,),
                     lambda: paged_kvattn_ref(*pargs), B * n_live * 4),
                    ("kvattn", kvattn, dargs + (bs, spec),
                     lambda: kvattn_ref(*dargs, bs), 0)):
                out, ref = fn(*args), plain()
                torch.cuda.synchronize()
                check(torch.isfinite(out.float()).all().item(),
                      f"{kern} {fmt} not finite")
                err = (out.float() - ref.float()).abs().max().item()
                tol = ATTN_REL_TOL * ref.float().abs().max().item()
                check(err <= tol, f"{kern} {fmt} T={T}: |Δ|={err} > {tol}")
                outs[kern] = out
                nbytes = keys * Hkv * (2 * rb + 8) + \
                    2 * B * Hkv * R * D * 2 + B * 4 + extra
                b, by = bound_ms(nbytes, ops)
                rows[kern].append(dict(
                    shape=f"{fmt} B={B} Hkv={Hkv} rep={rep} D={D} T={T} "
                          f"R={R} bs={bs} n_live={n_live} S={S}",
                    max_abs_err=err, tol=tol,
                    ms=time_ms(lambda: fn(*args), flush),
                    plain_ms=time_ms(plain, flush),
                    library_ms=time_ms(sdpa, flush),
                    bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
                    ops_per_s=BF16_OPS_PER_S))
            check(torch.equal(outs["kvattn"], outs["paged_kvattn"]),
                  f"dense and paged attention differ ({fmt}, T={T})")
            if T > 1:
                # a chunk's rows are the bits of its tokens fed one at a
                # time, and of each slot served alone
                for t in (0, T // 2, T - 1):
                    qt = q[:, :, t * rep:(t + 1) * rep].contiguous()
                    one = kvattn(qt, *dargs[1:5], posd + t, NO_WINDOW, rep,
                                 bs, spec)
                    check(torch.equal(one, outs["kvattn"][
                        :, :, t * rep:(t + 1) * rep]),
                        f"kvattn {fmt}: token {t} of a chunk differs from "
                        "its T 1 row")
                for b in range(B):
                    one = kvattn(q[b:b + 1].contiguous(), slab.k[b:b + 1],
                                 slab.k_scale[b:b + 1], slab.v[b:b + 1],
                                 slab.v_scale[b:b + 1], posd[b:b + 1],
                                 NO_WINDOW, rep, bs, spec)
                    check(torch.equal(one, outs["kvattn"][b:b + 1]),
                          f"kvattn {fmt}: slot {b} alone differs from its "
                          "batch row")
    return rows


def kept_pairs(S, causal, window):
    """(query, key) pairs the flash-prefill mask keeps at length S: key
    kpos < S, kpos <= qpos if causal, kpos > qpos - window."""
    win = S if window is None else window
    return sum(max(0, (q + 1 if causal else S) - max(0, q - win + 1))
               for q in range(S))


def flash_inputs(gen, B, H, Hkv, S, D, dev):
    """q, k, v whose scores single out a few keys per row: q ~ 4 N(0, 1)
    gives scaled scores of std 4, so one key or a mask edge moves the
    output by O(1).  q and k also carry opposite constant offsets that
    lower every real score by 20, under the 0 that an all-zero padding
    key past S would score: an unmasked padding key would swamp the
    row.  v ~ N(0, 1) / 4 keeps outputs within ~1, so the bar (two bf16
    ulps of the largest output) stays under 3e-2."""
    import torch
    c = (20 / D ** 0.5) ** 0.5
    q, k, v = (torch.randn(B, h, S, D, generator=gen, device=dev)
               for h in (H, Hkv, Hkv))
    return [t.to(torch.bfloat16) for t in (4 * q - c, k + c, v / 4)]


def flash_phase(dev, flush):
    """The flash-prefill kernel against its plain version (the same tile
    walk in PyTorch ops) at the one-shot serves' shapes; SDPA with the
    same mask as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashprefill import flash_prefill, pick_tile, \
        tiles
    from repro_torch.kernels.ref import NO_WINDOW, flash_prefill_walk
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for name, B, H, Hkv, S, D, causal, window in FLASH_SHAPES:
        q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dev)
        win = NO_WINDOW if window is None else window
        kw = dict(causal=causal, window=window)
        tile = pick_tile(B, H, Hkv, S, D)
        plain = lambda: flash_prefill_walk(   # noqa: E731
            q, k, v, causal, win, S, *tile)
        out, ref = flash_prefill(q, k, v, **kw), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"flash_prefill {name} not finite")
        err = (out.float() - ref.float()).abs().max().item()
        tol = FLASH_REL_TOL * ref.float().abs().max().item()
        check(err <= tol, f"flash_prefill {name}: |Δ|={err} > {tol}")
        pos = torch.arange(S, device=dev)
        mask = None
        if causal or window is not None:
            mask = pos[None] > pos[:, None] - win
            if causal:
                mask &= pos[None] <= pos[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=Hkv != H)
        lib = sdpa()
        check(torch.isfinite(lib.float()).all().item(), "SDPA not finite")
        nbytes = 2 * 2 * B * H * S * D + 2 * 2 * B * Hkv * S * D
        ops = 4 * D * B * H * kept_pairs(S, causal, window)
        b, by = bound_ms(nbytes, ops)
        rows.append(dict(
            shape=f"{name} B={B} H={H} Hkv={Hkv} D={D} causal={causal} "
                  f"window={window} tile={tile[0]}x{tile[1]}",
            max_abs_err=err, tol=tol,
            sdpa_max_abs_err=(lib.float() - ref.float()).abs().max().item(),
            ms=time_ms(lambda: flash_prefill(q, k, v, **kw), flush),
            plain_ms=time_ms(plain, flush, iters=5),
            library_ms=time_ms(sdpa, flush),
            bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
            ops_per_s=BF16_OPS_PER_S,
            # every tile the wrapper can choose: the evidence for its rule
            tile_sweep_ms={f"{bq}x{bk}": time_ms(
                lambda: flash_prefill(q, k, v, tile=(bq, bk), **kw),
                flush) for bq, bk in tiles(D)}))
    return {"flash_prefill": rows}


def to_device(params, dev, policy):
    """Parameter dict/list of tensors and PackedWeights → ``dev``, packed
    weights on the card in the fragment order of the GEMM kernel
    ``policy`` routes to (as the engine's ``quantize_params`` lays them
    out there)."""
    import torch
    from repro_torch.core.packing import PackedWeight, to_kernel_layout
    if isinstance(params, dict):
        return {k: to_device(v, dev, policy) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, dev, policy) for v in params]
    if isinstance(params, PackedWeight) and torch.device(dev).type == "cuda":
        return to_kernel_layout(params.to(dev),
                                "a8" if policy.int8_matmul else "a16")
    return params.to(dev)



def new_cache(model, policy, kind, slots, dev):
    """A fresh 256-token-per-slot cache of ``kind`` (paged: 16-token
    blocks, slot b's table row mapping its own blocks in shuffled order)
    and the decode_step keywords the engine passes with it."""
    import torch
    if kind == "dense":
        return model.init_cache(policy, slots, 256, dev), \
            lambda p: dict(attn_block_s=16)
    cache = model.init_paged_cache(policy, slots, 16 * slots, 16, 16, dev)
    perm = torch.randperm(16 * slots, generator=torch.Generator()
                          .manual_seed(slots)).to(torch.int32)
    cache.block_table.copy_(perm.reshape(slots, 16))

    def live(p):
        from repro_torch.core.paged_kvcache import blocks_needed
        return dict(max_live=min(1 << (blocks_needed(p + 1, 16) - 1)
                                 .bit_length(), 16) * 16)
    return cache, live


def teacher_forced(model, params, policy, cache, kw, stream, chunks):
    """Feed ``stream`` (1-D list) through decode_step in ``chunks`` (lists
    of token counts); returns the float logits of every step's last row."""
    import torch
    dev = cache.k.device
    out, p = [], 0
    for n in chunks:
        toks = torch.tensor([stream[p:p + n]], dtype=torch.int64, device=dev)
        logits, _ = model.decode_step(
            params, policy, toks, cache,
            torch.tensor([p], dtype=torch.int32, device=dev), **kw(p))
        out.append(logits[0].float().cpu())
        p += n
    return out


def reference_phase(dev):
    """REDUCED smollm: the kernels on the card against the plain versions
    on the CPU, teacher-forced, same packed weights, both backends."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    cfg = get_reduced("smollm-360m")
    model = build(cfg)
    raw = model.init_params(0, "cpu")
    stream = torch.randint(1, cfg.vocab, (12,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    chunks = [4, 4] + [1] * 4
    worst = {}
    for name, *_ in SERVES:
        pol = get_policy(name)
        params = quantize_params(raw, pol)
        tol = TOL_A8 if pol.int8_matmul else TOL
        for kind in ("dense", "paged"):
            logits = {}
            for d in ("cpu", dev):
                cache, kw = new_cache(model, pol, kind, 1, d)
                logits[str(d)] = teacher_forced(model,
                                                to_device(params, d, pol),
                                                pol, cache, kw, stream,
                                                chunks)
            worst[f"{name}/{kind}"] = compare_logits(
                logits["cpu"], logits[str(dev)], tol, f"{name} {kind}")
    return worst


def one_shot_teacher_forced(model, params, policy, stream, P, extra,
                            max_seq, dev):
    """Prefill ``stream[:P]`` into a fresh B=1 cache, then feed the rest
    one token at a time through decode_step; returns the float logits of
    the prefill and of every step."""
    import torch
    cache = model.init_cache(policy, 1, max_seq, dev)
    logits, cache = model.prefill(
        params, policy, torch.tensor([stream[:P]], device=dev), cache,
        **extra)
    out = [logits[0].float().cpu()]
    for p in range(P, len(stream)):
        logits, cache = model.decode_step(
            params, policy, torch.tensor([[stream[p]]], device=dev), cache,
            torch.tensor([p], dtype=torch.int32, device=dev))
        out.append(logits[0].float().cpu())
    return out


def compare_logits(ref, got, tol, what):
    """Card logits within ``tol`` · max |logit| of the CPU's, top-1 equal
    where the CPU's top-2 margin is clear; returns the worst relative
    error."""
    import torch
    rel_max = 0.0
    for lc, lg in zip(ref, got):
        check(torch.isfinite(lg).all().item(),
              f"reference logits not finite ({what})")
        scale = lc.abs().max().item()
        rel = (lg - lc).abs().max().item() / scale
        rel_max = max(rel_max, rel)
        check(rel <= tol, f"REDUCED {what}: card vs CPU rel err {rel} > "
                          f"{tol}")
        top2 = lc.topk(2).values
        if (top2[0] - top2[1]).item() > tol * scale:
            check(lg.argmax().item() == lc.argmax().item(),
                  f"top-1 differs ({what})")
    return rel_max


def one_shot_reference(dev):
    """REDUCED recurrentgemma and whisper: one-shot prefill (the
    flash-prefill kernel) then teacher-forced decode steps, the card
    against the CPU's plain versions, same packed weights and frames."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    worst = {}
    for arch, *_ in ONE_SHOT_SERVES:
        cfg = get_reduced(arch)
        model = build(cfg)
        raw = model.init_params(0, "cpu")
        extra = model.extra_inputs(5, 1, "cpu")
        stream = torch.randint(1, cfg.vocab, (12,), generator=torch.Generator()
                               .manual_seed(6)).tolist()
        for name in ("w4a16kv8", "w16a16kv16"):
            pol = get_policy(name)
            params = quantize_params(raw, pol)
            logits = {str(d): one_shot_teacher_forced(
                model, to_device(params, d, pol), pol, stream, 8,
                {k: v.to(d) for k, v in extra.items()}, 32, d)
                for d in ("cpu", dev)}
            worst[f"{arch}/{name}"] = compare_logits(
                logits["cpu"], logits[str(dev)], TOL, f"{arch} {name}")
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


def launch_counters():
    """The five kernel wrappers, by name."""
    from repro_torch.kernels.flashprefill import flash_prefill
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    return {"mpgemm_a16": mpgemm_a16, "mpgemm_int8": mpgemm_int8,
            "paged_kvattn": paged_kvattn, "kvattn": kvattn,
            "flash_prefill": flash_prefill}


def serve_one(dev, policy, kind, n_req, prompt_len, new_tokens, totals):
    """Serve full-width smollm-360m once; check the kernels carried every
    GEMM and attention call.  Adds the run's launches to ``totals``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import (Engine, EngineConfig, SamplingParams,
                                     percentile_stats)
    cfg = get_config("smollm-360m")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(model=cfg, policy=policy, cache_kind=kind,
                              n_slots=4, max_seq=256, block_size=16,
                              prefill_chunk=32, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n_req, prompt_len)).tolist()
    sp = SamplingParams(max_new_tokens=new_tokens)
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))   # warm-up

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    steps0 = eng.model_steps
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    steps = eng.model_steps - steps0
    for k, n in launches.items():
        totals[k] += n
    L = cfg.n_layers
    gemm = "mpgemm_int8" if eng.policy.int8_matmul else "mpgemm_a16"
    attn = "kvattn" if kind == "dense" else "paged_kvattn"
    check(len(outs) == n_req and all(
        len(o.output_token_ids) == new_tokens for o in outs),
        f"{policy}/{kind}: not every request produced its tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.output_token_ids),
          f"{policy}/{kind}: token outside the vocabulary")
    want = {k: 0 for k in launches}
    want[gemm], want[attn] = 7 * L * steps, L * steps
    check(launches == want, f"{policy}/{kind}: launches {launches} != "
                            f"{want} (L={L}, steps={steps})")
    if kind == "paged":
        check(eng.allocator.live_count == 0, "KV blocks leaked")

    res = dict(policy=policy, cache_kind=kind, requests=n_req,
               prompt_len=prompt_len, new_tokens=new_tokens,
               model_steps=steps, wall_s=wall,
               tokens_per_s=n_req * new_tokens / wall,
               ms_per_step=wall / steps * 1e3,
               ttft_p50_s=percentile_stats([o.ttft for o in outs])["p50"],
               latency_p50_s=percentile_stats([o.latency for o in outs])["p50"],
               setup_s=setup_s, launches=launches,
               kv_resident_bytes=eng.kv_resident_bytes())
    if policy == "w4a16kv8":
        # request 0, teacher-forced on the card: each emitted token must
        # be the argmax of decode_step's logits up to a near-tie
        stream = prompts[0] + outs[0].output_token_ids
        cache, kw = new_cache(eng.model, eng.policy, kind, 1, dev)
        chunks = [32] * (prompt_len // 32) + [1] * (new_tokens - 1)
        tf = teacher_forced(eng.model, eng.params, eng.policy, cache, kw,
                            stream, chunks)
        for lg, tok in zip(tf[prompt_len // 32 - 1:],
                           outs[0].output_token_ids):
            check(lg[tok].item() >= lg.max().item() - TOL *
                  lg.abs().max().item(),
                  f"{kind}: served token is not the teacher-forced argmax")
        res["profile"] = profile_window(eng, prompts[:4], SamplingParams(
            max_new_tokens=8))
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    streams = [o.output_token_ids for o in outs]
    del eng
    torch.cuda.empty_cache()
    return res, streams


def serve_one_shot(dev, arch, max_seq, n_req, prompt_len, new_tokens,
                   gemm_prefill, gemm_step, totals):
    """Serve full-width ``arch`` (a one-shot-prefill family) once on the
    dense slab under w4a16kv8; check that every prefill went through the
    flash-prefill kernel and every packed GEMM through the A16 kernel.
    Adds the run's launches to ``totals``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import (Engine, EngineConfig, SamplingParams,
                                     percentile_stats)
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                              max_seq=max_seq, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n_req, prompt_len)).tolist()
    sp = SamplingParams(max_new_tokens=new_tokens)
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))   # warm-up

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    steps0 = eng.model_steps
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    steps = eng.model_steps - steps0
    for k, n in launches.items():
        totals[k] += n
    check(len(outs) == n_req and all(
        len(o.output_token_ids) == new_tokens for o in outs),
        f"{arch}: not every request produced its tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.output_token_ids),
          f"{arch}: token outside the vocabulary")
    want = {k: 0 for k in launches}
    want["mpgemm_a16"] = gemm_prefill * n_req + gemm_step * steps
    want["flash_prefill"] = FLASH_PER_PREFILL * n_req
    check(launches == want, f"{arch}: launches {launches} != {want} "
                            f"({n_req} prefills, {steps} steps)")

    # request 0, teacher-forced on the card: each emitted token must be the
    # argmax of decode_step's logits up to a near-tie
    stream = prompts[0] + outs[0].output_token_ids[:-1]
    tf = one_shot_teacher_forced(eng.model, eng.params, eng.policy, stream,
                                 prompt_len - 1, eng._extra, max_seq, dev)
    for lg, tok in zip(tf[1:], outs[0].output_token_ids):
        check(lg[tok].item() >= lg.max().item() - TOL *
              lg.abs().max().item(),
              f"{arch}: served token is not the teacher-forced argmax")
    res = dict(arch=arch, policy="w4a16kv8", cache_kind="dense",
               requests=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
               model_steps=steps, wall_s=wall,
               tokens_per_s=n_req * new_tokens / wall,
               ms_per_step=wall / steps * 1e3,
               ttft_p50_s=percentile_stats([o.ttft for o in outs])["p50"],
               latency_p50_s=percentile_stats([o.latency for o in outs])["p50"],
               setup_s=setup_s, launches=launches,
               kv_resident_bytes=eng.kv_resident_bytes(),
               profile=profile_window(eng, prompts, SamplingParams(
                   max_new_tokens=8)),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del eng
    torch.cuda.empty_cache()
    return res


def serve_phase(dev):
    """Every serve of ``SERVES`` on both backends (dense and paged streams
    must be identical per policy), then the one-shot serves of
    ``ONE_SHOT_SERVES``.  Returns the runs and the launches of each kernel
    summed over them."""
    totals = {k: 0 for k in launch_counters()}
    runs = []
    for policy, n_req, plen, new in SERVES:
        streams = {}
        for kind in ("dense", "paged"):
            res, streams[kind] = serve_one(dev, policy, kind, n_req, plen,
                                           new, totals)
            runs.append(res)
            print("serve:", json.dumps(res))
        check(streams["dense"] == streams["paged"],
              f"{policy}: dense and paged token streams differ on the card")
    for serve in ONE_SHOT_SERVES:
        res = serve_one_shot(dev, *serve, totals)
        runs.append(res)
        print("serve:", json.dumps(res))
    for k, n in totals.items():
        check(n > 0, f"kernel {k} was never launched on the main path")
    return runs, totals


def ptxas_report(log):
    """(kernel<template ints>, registers, spill-store bytes) of every entry
    function in an ``nvcc -Xptxas -v`` log (kernels are templated on the
    KV format code and the head dim, or on GEMM tile constants)."""
    out, name, spill = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?\d+([A-Za-z]\w*?_kernel)I"
                      r"(\w*?)EEv", line)
        if m:
            args = re.findall(r"(?:Li|E)(\d+)", m.group(2))
            # anonymous-namespace names carry a file tag ending in digits
            name = f"{re.sub(r'^.*\d', '', m.group(1))}<{', '.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), spill))
    return out


def summarize(rows, launches, **meta):
    """One kernel's line: sums over its main-path shapes."""
    t_b = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
    t_o = sum(r["ops"] / r["ops_per_s"] for r in rows)
    libs = [r["library_ms"] for r in rows]
    return dict(meta, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None if None in libs else sum(libs),
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
        for kern, regs, spill in ptxas_report(
                p.with_suffix(".log").read_text()):
            print(f"  {p.stem.split('-')[0]} {kern}: {regs} registers, "
                  f"{spill} bytes spilled")

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for _ in range(1000):                 # ~0.4 s of work: clocks up
        flush.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = {**gemm_phase(dev, flush), **attn_phase(dev, flush),
            **flash_phase(dev, flush)}
    del flush
    for kern, rs in rows.items():
        for r in rs:
            lib = ("     —    " if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:7.1f} us")
            print(f"  {kern:12s} {r['shape']:58s} err {r['max_abs_err']:.3g}"
                  f" kernel {r['ms'] * 1e3:7.1f} us  plain "
                  f"{r['plain_ms'] * 1e3:8.1f} us  library {lib}  bound "
                  f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']})")
            if "tile_sweep_ms" in r:
                print("    tiles:", {t: round(ms * 1e3, 1) for t, ms in
                                     r["tile_sweep_ms"].items()}, "us")
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst = {**reference_phase(dev), **one_shot_reference(dev)}
    print(f"reference: REDUCED logits, card vs CPU, max rel err "
          f"{json.dumps(worst)} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    _, totals = serve_phase(dev)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")

    src = "src/repro_torch/csrc/"
    kernels = [
        summarize(rows["mpgemm_a16"], totals["mpgemm_a16"],
                  name="mpgemm_a16", route="cuda", source=src + "mpgemm.cu",
                  replaces="src/repro/kernels/mpgemm.py:137"),
        summarize(rows["mpgemm_int8"], totals["mpgemm_int8"],
                  name="mpgemm_int8", route="cuda",
                  source=src + "mpgemm_int8.cu",
                  replaces="src/repro/kernels/mpgemm.py:96"),
        summarize(rows["paged_kvattn"], totals["paged_kvattn"],
                  name="paged_kvattn", route="cuda",
                  source=src + "paged_kvattn.cu",
                  replaces="src/repro/kernels/paged_kvattn.py:85"),
        summarize(rows["kvattn"], totals["kvattn"], name="kvattn",
                  route="cuda", source=src + "kvattn.cu",
                  replaces="src/repro/kernels/kvattn.py:147"),
        summarize(rows["flash_prefill"], totals["flash_prefill"],
                  name="flash_prefill", route="cuda",
                  source=src + "flash_prefill.cu",
                  replaces="src/repro/kernels/flashprefill.py:82"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
