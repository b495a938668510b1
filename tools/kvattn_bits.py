#!/usr/bin/env python3
"""Check that the decode-attention kernels of several trees of this
repository give the same bits on one card: the dense-slab kernel
(``kvattn``) and the paged one (``paged_kvattn``) at every shape of
``chip_smoke.py``'s attention phase (the serve shapes in all four KV
formats, the sub-tiled tiles, gemma3-1b's D 288, the moe and vlm heads),
on the seeded stores of ``chip_smoke.kv_stores``, called as the older
trees call them: no key offset, no lse.

    python3 tools/kvattn_bits.py OLD NEW [--out build/kvattn_bits.json]

Each TREE is a checkout of the repository (``.`` for this one), run as
``tools/_bits.py`` says; the shapes and the stores are this tree's.
Prints, per shape and kernel, whether every tree's bytes equal the first
tree's; exits 1 if any differ.
"""
import sys

import _bits


def shapes():
    """(fmt, B, Hkv, rep, D, bs, bps, T, pos, window) of the attention
    phase."""
    C = _bits.chip_smoke()
    out = [(fmt, 4, 5, 3, 64, 16, 16, T, pos, None)
           for fmt in C.KV_FORMATS
           for T, pos in ((1, [95, 36, 70, 0]), (32, [32, 0, 64, 96]))]
    out += [tuple(s) + (None,) for s in C.SUB_TILES]
    out += [tuple(s) for s in C.D288_CASES]
    out += [tuple(s) + (None,) for s in C.MOE_VLM_ATTN]
    return out


def run_tree(cases) -> dict:
    """Digests of both kernels' outputs at ``cases`` with the wrappers on
    the path (one tree)."""
    import torch
    C = _bits.chip_smoke()
    from repro_torch.core.paged_kvcache import blocks_needed
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    from repro_torch.kernels.ref import NO_WINDOW
    specs = {"kv8": "w4a16kv8", "kv4": "w4a8kv4", "kvfp8": "w8a8kvfp8",
             "kv16": "w16a16kv16"}
    dev = torch.device("cuda")
    out = {}
    for i, (fmt, B, Hkv, rep, D, bs, bps, T, pos, window) in enumerate(cases):
        spec = get_policy(specs[fmt]).kv
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + i)
        ctx = [p + T for p in pos]
        pool, slab = C.kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx)
        q = torch.randn((B, Hkv, T * rep, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        posd = torch.tensor(pos, dtype=torch.int32, device=dev)
        win = NO_WINDOW if window is None else window
        n_live = blocks_needed(max(ctx), bs)
        dense = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd,
                       win, rep, bs, spec)
        paged = paged_kvattn(q, pool.k, pool.k_scale, pool.v, pool.v_scale,
                             pool.block_table, posd, win, rep, n_live, spec)
        torch.cuda.synchronize()
        out[f"{i:02d} {fmt} B={B} Hkv={Hkv} rep={rep} D={D} bs={bs} T={T} "
            f"window={window}"] = {"kvattn": _bits.digest(dense),
                                   "paged_kvattn": _bits.digest(paged)}
    return out


if __name__ == "__main__":
    sys.exit(_bits.main("kvattn", shapes, run_tree))
