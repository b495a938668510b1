#!/usr/bin/env python3
"""Check that the GEMM kernels of several trees of this repository give the
same bits on one card: ``mpgemm_a16`` and ``mpgemm_int8`` at every packed
shape of ``chip_smoke.py``'s GEMM phase, bits 4 and 8, at each shape's
token counts, on seeded weights and activations, each tree packing the
weights with its own ``pack_weight`` and ``to_kernel_layout``.

    python3 tools/gemm_bits.py OLD NEW [--out build/gemm_bits.json]

Each TREE is a checkout of the repository (``.`` for this one), run as
``tools/_bits.py`` says; the shapes are this tree's.  A shape a tree's
packer refuses (an older tree: a K of 32 × odd) is reported as refused
there and compared among the trees that ran it.  Prints, per shape and
kernel, whether every tree's bytes equal the first tree's; exits 1 if any
differ.
"""
import sys

import _bits


def shapes():
    """(name, K, N, bk, bn, Ms) of the GEMM phase."""
    C = _bits.chip_smoke()
    out = [(f"{fam} {s[0]}", *s[1:], C.GEMM_MS)
           for fam, table in (("smollm", C.GEMM_SHAPES),
                              ("recurrentgemma", C.RG_GEMM_SHAPES),
                              ("whisper", C.WH_GEMM_SHAPES))
           for s in table]
    out += [(*s, C.GEMM_MS) for s in C.DENSE_GEMM_SHAPES +
            C.RWKV_GEMM_SHAPES + C.TAIL_GEMM_SHAPES]
    return out + [tuple(s) for s in C.MOE_VLM_GEMM_SHAPES]


def run_tree(cases) -> dict:
    """Digests of both kernels' outputs at ``cases`` with the wrappers on
    the path (one tree); ``None`` where the tree refuses the weight."""
    import torch
    from repro_torch.core.packing import pack_weight, to_kernel_layout
    from repro_torch.core.quantize import quantize_act_per_token
    from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
    dev = torch.device("cuda")
    out = {}
    for i, (name, K, N, bk, bn, Ms) in enumerate(cases):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2000 + i)
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        for bits in (4, 8):
            pw = pack_weight(w, bits=bits, group=bk, block_k=bk,
                             block_n=bn)
            try:
                frag = {k: to_kernel_layout(pw, k) for k in ("a16", "a8")}
            except ValueError:
                frag = None
            for M in Ms:
                x = torch.randn(M, K, generator=gen, device=dev).to(
                    torch.bfloat16)
                key = f"{i:02d} {name} K={K} N={N} bits={bits} M={M}"
                if frag is None:
                    out[key] = None
                    continue
                xq, xs = quantize_act_per_token(x.float(), bits=8)
                y16 = mpgemm_a16(x, frag["a16"])
                y8 = mpgemm_int8(xq, xs, frag["a8"])
                torch.cuda.synchronize()
                out[key] = {"mpgemm_a16": _bits.digest(y16),
                            "mpgemm_int8": _bits.digest(y8)}
    return out


if __name__ == "__main__":
    sys.exit(_bits.main("gemm", shapes, run_tree, width=64))
