#!/usr/bin/env python3
"""Check that the flash kernels of several trees of this repository give
the same bits on one card: the forward (with and without the lse) at
``chip_smoke.FLASH_SHAPES`` and ``FLASH_BWD_SHAPES``, and the backward at
``FLASH_BWD_SHAPES``, at query position offset 0 (the serve and training
paths' calls), on seeded inputs; and the plain tile walk and plain
backward on the card the same way.

    python3 tools/flash_bits.py OLD NEW [--out build/flash_bits.json]

Each TREE is a checkout of the repository (``.`` for this one), run as
``tools/_bits.py`` says, calling its own wrappers with the same arguments
(no ``pos_offset``: the older trees' calls); the shapes are this tree's.
Prints, per shape and output, whether every tree's bytes equal the first
tree's; exits 1 if any differ.
"""
import sys

import _bits


def shapes():
    """(name, B, H, Hkv, Sq, Sk, D, causal, window) of the flash phases."""
    C = _bits.chip_smoke()
    return [(n, B, H, Hkv, S, S, D, c, w)
            for n, B, H, Hkv, S, D, c, w in C.FLASH_SHAPES] + \
        [list(s) for s in C.FLASH_BWD_SHAPES]


def run_tree(shapes) -> dict:
    """Digests of every output at ``shapes`` with the wrappers on the
    path (one tree)."""
    import torch
    from repro_torch.kernels.flashprefill import (flash_prefill,
                                                  flash_prefill_bwd,
                                                  pick_tile)
    from repro_torch.kernels.ref import (NO_WINDOW, flash_prefill_bwd_ref,
                                         flash_prefill_walk)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for name, B, H, Hkv, Sq, Sk, D, causal, window in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(Sq * 7 + Sk + D)
        c = (20 / D ** 0.5) ** 0.5
        q, k, v, do = (torch.randn(B, h, n, D, generator=gen, device=dev)
                       for h, n in ((H, Sq), (Hkv, Sk), (Hkv, Sk), (H, Sq)))
        q, k, v, do = (t.to(torch.bfloat16) for t in
                       (4 * q - c, k + c, v / 4, do))
        kw = dict(causal=causal, window=window)
        win = NO_WINDOW if window is None else window
        o, lse = flash_prefill(q, k, v, return_lse=True, **kw)
        row = {"fwd": _bits.digest(flash_prefill(q, k, v, **kw)),
               "fwd_lse": _bits.digest(o) + _bits.digest(lse)}
        walk = flash_prefill_walk(q, k, v, causal, win, Sk,
                                  *pick_tile(B, H, Hkv, Sq, D),
                                  return_lse=True)
        row["plain_fwd"] = _bits.digest(walk[0]) + _bits.digest(walk[1])
        if Sq == Sk or not causal:
            row["bwd"] = "".join(_bits.digest(g) for g in flash_prefill_bwd(
                q, k, v, o, lse, do, **kw))
            row["plain_bwd"] = "".join(_bits.digest(g) for g in
                                       flash_prefill_bwd_ref(
                                           q, k, v, o, lse, do, causal, win,
                                           Sk))
        torch.cuda.synchronize()
        out[name] = row
    return out


if __name__ == "__main__":
    sys.exit(_bits.main("flash", shapes, run_tree, width=32))
